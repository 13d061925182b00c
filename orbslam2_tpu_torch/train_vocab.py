"""Train an ORB vocabulary from diverse synthetic textures.

Counterpart of the JAX package's scripts/train_vocab.py (the role of the
reference's Vocabulary/ training): descriptors from a mix of block
textures, smooth blobs, mixed-scale squares, binary noise and ray-traced
room renders (io/synth.py), then the hierarchical k-medians tree and its
idf weights (io/vocabulary.train_vocabulary). On the card the extraction,
every Hamming distance of the split (the `hamming_best2` kernel) and the
idf pass (the `bow_assign` kernel) run there; the tree equals the host
trainer's on the same descriptors.

    python3 -m orbslam2_tpu_torch.train_vocab OUT.npz [--k 10] [--levels 5]
        [--scenes 240] [--features 3000] [--max-train 800000]
        [--device cuda|cpu]

The output path is required: the package's own vocabulary
(data/vocab_default.npz) is never overwritten. The file is the npz that
both packages' `Vocabulary.load` read. The default device is the card;
without one the command fails unless the CPU is asked for.
"""
from __future__ import annotations

import argparse
import sys
import time

import numpy as np
import torch

from .config import OrbParams
from .interop import desc_i32_to_u32
from .io import synth
from .io.vocabulary import train_vocabulary
from .ops import cuda_kernels as CK
from .ops.features import extract_orb

HEIGHT, WIDTH = 480, 640


def _gaussian_filter(img: np.ndarray, sigma: float) -> np.ndarray:
    """scipy.ndimage.gaussian_filter(img, sigma) of a 2-D image: a separable
    correlation along axis 0, then axis 1, with the weights
    exp(-x^2 / 2 sigma^2) normalised over radius int(4 sigma + 0.5), in
    scipy's mode "reflect" (half-sample symmetric: numpy's "symmetric"
    pad), in float64."""
    r = int(4.0 * sigma + 0.5)
    x = np.arange(-r, r + 1)
    w = np.exp(-0.5 / (sigma * sigma) * x.astype(np.float64) ** 2)
    w /= w.sum()
    out = np.asarray(img, np.float64)
    for axis in (0, 1):
        pad = [(0, 0), (0, 0)]
        pad[axis] = (r, r)
        p = np.moveaxis(np.pad(out, pad, mode="symmetric"), axis, 0)
        n = out.shape[axis]
        acc = np.zeros((n,) + p.shape[1:])
        for j in range(2 * r + 1):
            acc += w[j] * p[j:j + n]
        out = np.moveaxis(acc, 0, axis)
    return out


def gather_descriptors(n_scenes: int, n_features: int, device) -> np.ndarray:
    """The JAX script's descriptor set, draw for draw from
    np.random.default_rng(0): scene `trial` is image mode trial % 5, with
    noise rng.normal(0, 2) and clipping to [0, 255] float32, extracted by
    this package's extract_orb on `device` at 480x640. Returns the valid
    descriptors as [N, 8] uint32 words."""
    rng = np.random.default_rng(0)
    params = OrbParams(n_features=n_features)
    descs = []
    room = None
    for trial in range(n_scenes):
        mode = trial % 5
        if mode == 0:  # block texture
            cell = rng.integers(4, 16)
            img = np.kron(rng.uniform(0, 255, (HEIGHT // cell + 1, WIDTH // cell + 1)),
                          np.ones((cell, cell)))[:HEIGHT, :WIDTH]
        elif mode == 1:  # smooth blobs
            img = rng.uniform(0, 255, (30, 40))
            img = np.kron(img, np.ones((16, 16)))
            img = _gaussian_filter(img, rng.uniform(1, 4))
        elif mode == 2:  # mixed-scale squares
            img = np.full((HEIGHT, WIDTH), 128.0)
            for _ in range(rng.integers(100, 300)):
                s = rng.integers(2, 20)
                y, x = rng.integers(0, HEIGHT - s), rng.integers(0, WIDTH - s)
                img[y:y + s, x:x + s] = rng.uniform(0, 255)
        elif mode == 3:  # binary noise
            img = (rng.random((120, 160)) > 0.5) * 255.0
            img = np.kron(img, np.ones((4, 4)))
        else:  # ray-traced room views (the e2e scenes' texture statistics)
            if trial % 40 == 4 or room is None:
                room = synth.make_room(seed=int(rng.integers(1 << 30)))
            ang = rng.uniform(0, 2 * np.pi)
            c, s = np.cos(ang), np.sin(ang)
            R = np.array([[c, 0, s], [0, 1, 0], [-s, 0, c]], np.float32)
            t = rng.uniform(-0.5, 0.5, 3).astype(np.float32)
            T = np.hstack([R, t[:, None]]).astype(np.float32)
            img = synth.render_room(room, T, seed=int(rng.integers(1 << 30)))
        img = img + rng.normal(0, 2, img.shape)
        f = extract_orb(torch.from_numpy(np.clip(img, 0, 255).astype(np.float32)).to(device),
                        params, HEIGHT, WIDTH)
        v = f.valid.cpu().numpy()
        descs.append(desc_i32_to_u32(f.desc.cpu().numpy()[v]))
        if trial % 20 == 0:
            print(f"scene {trial}/{n_scenes}: {v.sum()} descs "
                  f"(total {sum(len(d) for d in descs)})", flush=True)
    return np.concatenate(descs)


def root_split_ms(desc: np.ndarray, k: int) -> float | None:
    """Device time of one `hamming_best2` at the root split's shape [N, k]
    (CUDA events around calls queued behind a spin kernel, warm)."""
    from .utils import cuda_timing
    a = torch.from_numpy(np.ascontiguousarray(desc, np.uint32).view(np.int32)).cuda()
    every = torch.ones((len(a), k), dtype=torch.bool, device=a.device)
    b = a[:k].contiguous()
    return cuda_timing.queued_ms(lambda: CK.hamming_best2(a, b, every))


def parse_args(argv):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("out", help="the .npz to write")
    ap.add_argument("--k", type=int, default=10)
    ap.add_argument("--levels", type=int, default=5)
    ap.add_argument("--scenes", type=int, default=240)
    ap.add_argument("--features", type=int, default=3000)
    ap.add_argument("--max-train", type=int, default=800_000)
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    return ap.parse_args(argv)


def main(argv=None) -> int:
    args = parse_args(argv)
    if args.device == "cuda" and not torch.cuda.is_available():
        print("no CUDA device: run on the card, or pass --device cpu", file=sys.stderr)
        return 2
    t0 = time.time()
    all_desc = gather_descriptors(args.scenes, args.features, args.device)
    gather_s = time.time() - t0
    print(f"total descriptors: {len(all_desc)} ({gather_s:.0f}s)")
    CK.reset_launch_counts()
    seconds: dict = {}
    t0 = time.time()
    voc = train_vocabulary(all_desc, k=args.k, levels=args.levels, seed=0,
                           max_train=args.max_train, device=args.device, seconds=seconds)
    print(f"trained in {time.time() - t0:.0f}s")
    voc.save(args.out)
    print("saved", args.out, "words:", voc.n_words)
    launches = {w.__name__: w.launches_by.get("vocab", 0)
                for w in (CK.hamming_best2, CK.bow_assign)}
    line = (f"nodes {len(voc.node_desc)}, words {voc.n_words}; seconds: gather "
            f"{gather_s:.1f}, split {seconds['split']:.1f}, idf {seconds['idf']:.1f}; "
            f"launches under vocab {launches}")
    if args.device == "cuda":
        from .utils.cuda_timing import card_line, fmt_ms
        n = min(len(all_desc), args.max_train)
        line += (f"; hamming_best2 at the root shape [{n},{args.k}] "
                 f"{fmt_ms(root_split_ms(all_desc[:n], args.k))} (device, warm); "
                 f"card {card_line()}")
    print(line, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
