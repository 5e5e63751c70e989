"""deconv_rl_ms.apply512: device ms (CUDA events) of the Richardson-Lucy part:
the kernel's host set-up, its copies, launches and checkpoints (the
program's ``deconv.rl`` span), per traced Apply, in the 512² cell."""

from portbench import program_spans


def read(run):
    return program_spans.device_ms(run, "apply", "deconv.rl")
