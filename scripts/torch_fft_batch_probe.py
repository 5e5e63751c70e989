"""Does a row's batched FFT, or its sum of squares, keep its bits whatever
the batch it is computed in? The question behind ``ops/fourier.MIN_FFT_ROWS``,
``ops/fourier.pairs_rows`` and ``ops/intensity.intensity_image``'s aligned
stride: a rank's block of a sharded cube must get the whole cube's values.

    python3 scripts/torch_fft_batch_probe.py [--device cuda] [--min-rows 8192]
        [--lengths 1024 128 64 1488 745 1023 1606]

For each trace length (even, short, the tilted T = 1488, the odd 745 and
1023, and the tilted T = 1606, whose rows lie at two alignments), it takes
rows of a 40 000-row random batch as batches of 1 to 40 000 rows, at
offsets 0-3 and 7 (with a length that is not a multiple of 4, an offset
moves rows to other alignments than they have in the whole batch), and
prints, per length, the number of rows whose bits differ from the whole
batch's:

* ``rfft``, ``irfft``, ``sumsq``: ``torch.fft.rfft`` / ``irfft`` and the
  per-row sum of squares (the intensity image) as the library runs them on
  contiguous rows;
* ``rfft_padded``, ``irfft_padded``: the batch padded with zero rows to
  ``--min-rows`` (as ``ops.fourier.batch_fft`` does);
* ``rfft_aligned_padded``, ``sumsq_aligned``: the rows laid at a stride
  rounded up to 4 floats (16 bytes), in the whole batch and in the part
  alike, and the functions run on the ``[..., :n]`` view;
* ``rfft_interleaved``, ``irfft_interleaved``: the padded batch with a zero
  row after every row (cuFFT transforms rows of an odd length two at a
  time), as ``ops.fourier.batch_fft`` runs an odd length.

It needs the card unless ``--device cpu``.
"""

import argparse

import torch

BATCHES = (1, 33, 100, 1000, 1089, 1152, 2178, 4096, 4356, 8191, 8192, 10000, 20000, 40000)


def padded(fn, x, rows, **kw):
    if rows <= 0 or x.shape[0] >= rows:
        return fn(x, dim=-1, **kw)
    p = torch.cat([x, x.new_zeros((rows - x.shape[0], *x.shape[1:]))])
    return fn(p, dim=-1, **kw)[: x.shape[0]]


def aligned(x):
    """``x`` (rows, n) as the ``[:, :n]`` view of rows at a stride of n
    rounded up to 4 floats."""
    n = x.shape[-1]
    buf = x.new_zeros((x.shape[0], -(-n // 4) * 4))
    buf[:, :n] = x
    return buf[:, :n]


def variants(x, c, n, min_rows):
    xa = aligned(x)
    return dict(rfft=torch.fft.rfft(x, dim=-1), irfft=torch.fft.irfft(c, n=n, dim=-1),
                rfft_padded=padded(torch.fft.rfft, x, min_rows),
                irfft_padded=padded(torch.fft.irfft, c, min_rows, n=n),
                rfft_aligned_padded=padded_aligned(xa, min_rows),
                rfft_interleaved=interleaved(torch.fft.rfft, x, min_rows),
                irfft_interleaved=interleaved(torch.fft.irfft, c, min_rows, n=n),
                sumsq=torch.sum(x * x, dim=-1),
                sumsq_aligned=_sumsq_view(xa))


def interleaved(fn, x, rows, **kw):
    """``fn`` over the batch padded with zero rows to ``rows``, each row
    followed by a zero row."""
    want = max(rows, x.shape[0])
    pairs = x.new_zeros((want, 2, x.shape[-1]))
    pairs[: x.shape[0], 0] = x
    out = fn(pairs.reshape(2 * want, x.shape[-1]), dim=-1, **kw)
    return out.reshape(want, 2, out.shape[-1])[: x.shape[0], 0]


def padded_aligned(xa, rows):
    """``rfft`` of rows at the aligned stride, the batch padded with zero
    rows (at the same stride) to ``rows``."""
    n = xa.shape[-1]
    base = xa.new_zeros((max(rows, xa.shape[0]), -(-n // 4) * 4))
    base[: xa.shape[0], :n] = xa
    return torch.fft.rfft(base[:, :n], dim=-1)[: xa.shape[0]]


def _sumsq_view(xa):
    """The per-row sum of squares of rows at the aligned stride: the
    squares written at the same stride, summed over the view."""
    n = xa.shape[-1]
    sq = xa.new_zeros((xa.shape[0], -(-n // 4) * 4))
    torch.mul(xa, xa, out=sq[:, :n])
    return torch.sum(sq[:, :n], dim=-1)


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--min-rows", type=int, default=8192)
    ap.add_argument("--lengths", type=int, nargs="+",
                    default=[1024, 128, 64, 1488, 745, 1023, 1606])
    args = ap.parse_args()
    dev = torch.device(args.device)
    if dev.type == "cuda":
        print(torch.cuda.get_device_name(0), torch.version.cuda, flush=True)
    torch.manual_seed(0)
    for n in args.lengths:
        x_all = torch.randn(40000, n, device=dev)
        c_all = torch.randn(40000, n // 2 + 1, dtype=torch.complex64, device=dev)
        want = variants(x_all, c_all, n, args.min_rows)
        differ = {}
        for b in BATCHES:
            for off in (0, 1, 2, 3, 7):
                x, c = x_all[off: off + b].clone(), c_all[off: off + b].clone()
                got = variants(x, c, n, args.min_rows)
                for key, g in got.items():
                    w = want[key][off: off + x.shape[0]]
                    bad = int((g != w).reshape(g.shape[0], -1).any(dim=-1).sum())
                    if bad:
                        differ.setdefault(key, {})[f"{b}@{off}"] = bad
        print(f"length {n}: rows that differ from the 40 000-row batch, by batch@offset: "
              f"{differ or 'none'}", flush=True)


if __name__ == "__main__":
    main()
