"""Generate toroidal blue-noise masks by void-and-cluster (port of
tools/bluenoise_gen.py).

    python -m rtrt_tpu_torch.tools.bluenoise_gen --out PATH.npy
        [--size 64] [--device cuda|cpu]

Ulichney's void-and-cluster method: a 10% random binary pattern relaxed
by swapping its tightest cluster into its largest void, then every pixel
ranked by removing clusters down to empty and filling voids up to full;
the energy is the pattern convolved with a toroidal Gaussian (sigma 1.9)
by FFT.  The frame uses the masks as Cranley-Patterson rotation offsets
(render/sampling.py::blue_noise_mask), which spreads the 1-spp error as
blue noise between pixels.  One (size, size) float32 rank mask in [0, 1)
a seed, stacked on the last axis: resources/bluenoise64.npy is (64, 64, 2)
of seeds 11 and 23 (SEEDS).  The loops run in torch on --device (float64
FFTs, argmin / argmax there); on the CPU they give the JAX tool's numpy
masks bit for bit.  The tool writes only to --out; the first line
printed is the card's name and power limit, and without a card it exits
non-zero unless --device cpu is given.
"""

from __future__ import annotations

import argparse
import sys

import numpy as np

SIZE = 64
SIGMA = 1.9  # Ulichney's recommended gaussian width
SEEDS = (11, 23)


def _energy_kernel(size, sigma):
    """Toroidal gaussian energy splat, centered at (0,0)."""
    ax = np.arange(size)
    d = np.minimum(ax, size - ax).astype(np.float64)  # toroidal distance
    d2 = d[:, None] ** 2 + d[None, :] ** 2
    return np.exp(-d2 / (2.0 * sigma * sigma))


def _initial_pattern(size, seed):
    """The seeded 10% random binary pattern (numpy's generator, as the JAX
    tool's)."""
    n = size * size
    count = n // 10
    binary = np.zeros((size, size), bool)
    idx = np.random.default_rng(seed).choice(n, count, replace=False)
    binary[np.unravel_index(idx, binary.shape)] = True
    return binary, count


def void_and_cluster(size=SIZE, sigma=SIGMA, seed=0, device="cuda"):
    """(size, size) float32 rank mask in [0, 1) (Ulichney 1993), in torch
    on `device`: the pattern, energies and ranks stay there; the
    relaxation reads one flag a swap back to the host."""
    import torch

    n = size * size
    init, count = _initial_pattern(size, seed)
    kf = torch.fft.rfft2(torch.from_numpy(_energy_kernel(size, sigma)).to(
        device))
    inf = torch.tensor(float("inf"), dtype=torch.float64, device=device)

    def energy(b):
        return torch.fft.irfft2(torch.fft.rfft2(b.to(torch.float64)) * kf,
                                s=b.shape).reshape(-1)

    binary = torch.from_numpy(init).to(device).reshape(-1)
    for _ in range(10 * n):
        cluster = torch.argmax(torch.where(binary, energy(
            binary.reshape(size, size)), -inf))
        binary[cluster] = False
        void = torch.argmin(torch.where(binary, inf, energy(
            binary.reshape(size, size))))
        binary[void] = True
        if bool(void == cluster):
            break

    rank = torch.zeros(n, dtype=torch.int64, device=device)
    # phase 1: remove tightest clusters down to empty, ranking backwards
    b = binary.clone()
    for r in range(count - 1, -1, -1):
        p = torch.argmax(torch.where(b, energy(b.reshape(size, size)), -inf))
        b[p] = False
        rank[p] = r
    # phase 2: fill biggest voids up from the initial pattern
    b = binary.clone()
    for r in range(count, n):
        p = torch.argmin(torch.where(b, inf, energy(b.reshape(size, size))))
        b[p] = True
        rank[p] = r
    return ((rank.to(torch.float64) + 0.5) / n).to(torch.float32).reshape(
        size, size).cpu().numpy()


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--out", required=True,
                   help="the .npy file to write ((size, size, seeds))")
    p.add_argument("--size", type=int, default=SIZE)
    p.add_argument("--device", default="cuda",
                   help="cuda (the default) or cpu")
    args = p.parse_args(argv)
    from ..utils.timing import device_line
    print(device_line(args.device))
    masks = np.stack([void_and_cluster(args.size, seed=s,
                                       device=args.device) for s in SEEDS],
                     axis=-1)
    np.save(args.out, masks)
    print(f"wrote {args.out} {masks.shape} {masks.dtype}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
