"""chain_ms.drag: the executor's per-stage device ms (``Pipeline.
timings_ms``, CUDA events) summed over the stages a slider step re-ran,
averaged over the window's slider steps."""


def read(run):
    per = [sum(s.timings.get(n, 0.0) for n in s.stages)
           for s in run.window_steps("slider") if s.timings is not None and s.stages]
    return sum(per) / len(per) if per else None
