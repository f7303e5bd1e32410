"""Framework-overhead benchmark: the reference's InnerBenchmark.

Mirrors the reference's ``test/{sequential,parallel}/InnerBenchmark``: drive
the deterministic SequenceMove (pure framework cost, no likelihood) over the
reference workload (2400 walkers x 4 params) and report walker-updates/s
with :class:`~mcmcpp_tpu_torch.utils.ThroughputMonitor`. The prime-finding
busy-work of the reference (SequenceMove.h:135-162) simulated an expensive
CPU likelihood; pass ``--flops`` to add synthetic device FLOPs through a
dummy matmul logp. Exits non-zero when the positions after N steps are not
exactly N·step (steps of 2^-10, so every sum is exact in float32).

``--sharded`` (≙ ``test/parallel/InnerBenchmark``) splits the walkers over
the ranks of a process group (``torchrun``, or a group of one), padded so
that each half divides by the rank count; each rank checks its own walkers.

Usage:
    python -m mcmcpp_tpu_torch.examples.inner_benchmark [--device cuda|cpu] \
        [--walkers 2400] [--steps 20000] [--flops] [--sharded]
"""

import argparse
import contextlib
import sys

import numpy as np
import torch

from mcmcpp_tpu_torch import (
    EnsembleSampler,
    SequenceMove,
    ShardedEnsembleSampler,
)
from mcmcpp_tpu_torch.parallel import distributed
from mcmcpp_tpu_torch.utils import ThroughputMonitor

STEP = 2.0 ** -10


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--walkers", type=int, default=2400)
    ap.add_argument("--steps", type=int, default=20000)
    ap.add_argument("--params", type=int, default=4)
    ap.add_argument("--flops", action="store_true",
                    help="add synthetic likelihood FLOPs (64x64 matmul)")
    ap.add_argument("--sharded", action="store_true",
                    help="split the walkers over the process group's ranks")
    args = ap.parse_args(argv)
    with (distributed.process_group(args.device) if args.sharded
          else contextlib.nullcontext()):
        return run(args)


def run(args):

    p = args.params
    mover = SequenceMove(step_sizes=np.full(p, STEP))
    if args.flops:
        def logp(x):
            w_mat = torch.eye(64, dtype=x.dtype, device=x.device)
            wide = x.repeat(1, 64 // p + 1)[:, :64]
            return ((wide @ w_mat) * wide).sum(dim=1) * 0.0
    else:
        def logp(x):
            return torch.zeros_like(x[:, 0])

    cls, n_walkers = EnsembleSampler, args.walkers
    if args.sharded:  # pad so that each half divides by the rank count
        cls, step = ShardedEnsembleSampler, 2 * distributed.world_size()
        n_walkers = -(-n_walkers // step) * step
    s = cls(logp, n_walkers=n_walkers, n_params=p, seed=0, mover=mover,
            batched=True, device=args.device)
    s.set_initial_walker_pos(
        mover.initial_positions(None, n_walkers, device=s.device))
    warm = min(100, args.steps)
    s.run_mcmc(warm, store=False)
    mon = ThroughputMonitor(n_walkers=n_walkers)
    with mon.measure(steps=args.steps):
        s.run_mcmc(args.steps, store=False)
        pos = s.current_positions.cpu()  # waits for the device
    print(f"walkers={n_walkers} params={p} steps={args.steps} "
          f"device={s.device} ranks={distributed.world_size()}")
    print(f"{mon.updates_per_s / 1e6:.1f}M walker-updates/s "
          f"({mon.seconds / args.steps * 1e6:.1f} us/step)")
    # deterministic check ≙ parallel/InnerBenchmark main.cpp:65-69
    expect = (warm + args.steps) * STEP
    print(f"position after {warm + args.steps} steps: "
          f"{float(pos[0, 0])!r}, oracle {expect!r}")
    if not bool((pos == expect).all()):
        print("FAILED: positions are not exactly N·step")
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
