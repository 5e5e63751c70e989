"""Does a row's batched FFT, or its sum of squares, keep its bits whatever
the batch it is computed in? The question behind ``ops/fourier.MIN_FFT_ROWS``:
a rank's block of a sharded cube must get the whole cube's values.

    python3 scripts/torch_fft_batch_probe.py [--device cuda] [--min-rows 8192]

For trace lengths 1024, 128, 64, 1488 and 745 (even, short, the tilted
T = 1488, odd), it takes rows of a 40 000-row random batch as batches of 1 to
40 000 rows (at offset 0 and 7) and prints, per length, the number of rows
whose bits differ from the whole batch's: ``torch.fft.rfft`` and ``irfft``
as the library runs them, the same with the batch padded with zero rows to
``--min-rows`` (as ``ops.fourier.batch_fft`` does), and the per-row sum of
squares (the intensity image). It needs the card unless ``--device cpu``.
"""

import argparse

import torch

BATCHES = (1, 33, 100, 1000, 1089, 1152, 2178, 4096, 4356, 8191, 8192, 10000, 20000, 40000)


def padded(fn, x, rows, **kw):
    if rows <= 0 or x.shape[0] >= rows:
        return fn(x, dim=-1, **kw)
    p = torch.cat([x, x.new_zeros((rows - x.shape[0], *x.shape[1:]))])
    return fn(p, dim=-1, **kw)[: x.shape[0]]


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--min-rows", type=int, default=8192)
    args = ap.parse_args()
    dev = torch.device(args.device)
    if dev.type == "cuda":
        print(torch.cuda.get_device_name(0), torch.version.cuda, flush=True)
    torch.manual_seed(0)
    for n in (1024, 128, 64, 1488, 745):
        x_all = torch.randn(40000, n, device=dev)
        c_all = torch.randn(40000, n // 2 + 1, dtype=torch.complex64, device=dev)
        want = dict(
            rfft=torch.fft.rfft(x_all, dim=-1), irfft=torch.fft.irfft(c_all, n=n, dim=-1),
            rfft_padded=padded(torch.fft.rfft, x_all, args.min_rows),
            irfft_padded=padded(torch.fft.irfft, c_all, args.min_rows, n=n),
            sumsq=torch.sum(x_all * x_all, dim=-1))
        differ = {}
        for b in BATCHES:
            for off in (0, 7):
                x, c = x_all[off: off + b].clone(), c_all[off: off + b].clone()
                got = dict(rfft=torch.fft.rfft(x, dim=-1), irfft=torch.fft.irfft(c, n=n, dim=-1),
                           rfft_padded=padded(torch.fft.rfft, x, args.min_rows),
                           irfft_padded=padded(torch.fft.irfft, c, args.min_rows, n=n),
                           sumsq=torch.sum(x * x, dim=-1))
                for key, g in got.items():
                    w = want[key][off: off + x.shape[0]]
                    bad = int((g != w).reshape(g.shape[0], -1).any(dim=-1).sum())
                    if bad:
                        differ.setdefault(key, {})[f"{b}@{off}"] = bad
        print(f"length {n}: rows that differ from the 40 000-row batch, by batch@offset: "
              f"{differ or 'none'}", flush=True)


if __name__ == "__main__":
    main()
