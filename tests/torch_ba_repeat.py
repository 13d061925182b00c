"""Does `ops/ba.ba_solve` repeat itself on the CPU? Solves one seeded problem
(`ba.synthetic_problem(C, P, E, seed=0)`, the default schedule) several
times at a given torch thread count and prints how many different results
(hashes of the poses, points, inlier mask and cost) it got:

    python tests/torch_ba_repeat.py --size 64 2048 8192 --threads 4 --runs 8

`--trace` also records, in each solve, the input and output of every
Cholesky factorization and triangular solve of the dense Schur step, and
prints the first call where two solves part: the same input with another
output names the call that does not repeat. `--lapack` factors with
`torch.linalg.cholesky_ex` on the whole system, as the port did before its
blocked CPU factorization (`ba._cholesky`), so that both can be run in
turns.
"""
import argparse
import hashlib
import os
import sys

import torch

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), ".."))


def digest(*tensors) -> str:
    return hashlib.sha1(b"".join(t.detach().contiguous().numpy().tobytes()
                                 for t in tensors)).hexdigest()[:12]


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--size", type=int, nargs=3, default=(64, 2048, 8192),
                    metavar=("C", "P", "E"))
    ap.add_argument("--threads", type=int, default=4)
    ap.add_argument("--runs", type=int, default=8)
    ap.add_argument("--trace", action="store_true")
    ap.add_argument("--lapack", action="store_true")
    a = ap.parse_args()
    torch.set_num_threads(a.threads)
    from orbslam2_tpu_torch.ops import ba as BA
    if a.lapack:
        BA._cholesky = lambda S: torch.linalg.cholesky_ex(S, check_errors=False)[0]
    calls: list = []
    if a.trace:
        chol, solve = BA._cholesky, torch.cholesky_solve

        def traced_chol(S):
            L = chol(S)
            calls.append(("cholesky", digest(S), digest(L)))
            return L

        def traced_solve(b, L):
            x = solve(b, L)
            calls.append(("cholesky_solve", digest(b, L), digest(x)))
            return x
        BA._cholesky = traced_chol
        torch.cholesky_solve = traced_solve
    arrays, intr = BA.synthetic_problem(*a.size, seed=0)
    results, traces = {}, []
    for run in range(a.runs):
        calls.clear()
        res = BA.ba_solve(BA.problem_from_numpy(arrays, torch.device("cpu")), *intr)
        results.setdefault(digest(*res), []).append(run)
        traces.append(list(calls))
    C, P, E = a.size
    print(f"ba_solve C={C} P={P} E={E} at {a.threads} threads "
          f"({'LAPACK' if a.lapack else 'the port'}'s Cholesky): {len(results)} "
          f"different results in {a.runs} solves {results}")
    if a.trace:
        for i, (x, y) in enumerate(zip(*traces[:2])):
            if x != y:
                print(f"solves 1 and 2 part at call {i}: {x[0]}, input "
                      f"{'equal' if x[1] == y[1] else 'different'}, output "
                      f"{'equal' if x[2] == y[2] else 'different'}")
                break
        else:
            print("solves 1 and 2 made the same calls with the same results")
    return 0


if __name__ == "__main__":
    sys.exit(main())
