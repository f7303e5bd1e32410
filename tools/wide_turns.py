"""Time the wide Gaussian half-step of several checkouts in turns on one card.

    python3 tools/wide_turns.py 297,384,512 build/parent [OTHER_TREE ...]
    python3 tools/wide_turns.py 3000 build/parent --iters 3
    python3 tools/wide_turns.py 3000 build/variants/a build/variants/b --no-check

builds this checkout's kernel library and those of the other checkouts (for
example ``git archive <commit> mcmcpp_tpu_torch | tar -x -C build/parent``),
each from its own sources into its own ``build/kernels/``, then for each
width P at n = 2^20 walkers a half: holds each library's
``mcmcpp_fused_stretch_wide_f32`` to the plain half-step once (the accept
masks equal but for a few rows, the logps within 1e-5 relative), and times
the other checkouts' entry points, this one's and this one's loads-only
entry (where its route has one) in turns a, b, c, c, b, a: 20 launches a
reading (``--iters``: fewer past P ≈ 2000, where a launch takes hundreds of
ms) between CUDA events, queued behind some 6 ms of device work. A library
whose entry takes a scratch pointer (L's split stages from route 4 on,
route 6's Y buffers) gets a buffer of the bytes its own layout entry names.
Prints the milliseconds a launch with the card's name and power limit, and
this checkout's route at each P. With ``--no-check`` the other checkouts
are timed without being held to the plain half-step: for throwaway variants
that drop a piece of the kernel on purpose (its formation, its loads), to
see what each piece costs. Needs a CUDA device.
"""

import ctypes
import importlib.util
import os
import subprocess
import sys

import numpy as np
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def load(tree, label):
    """The kernel library of checkout ``tree``, built and typed by that
    checkout's own ``_build.py``."""
    path = os.path.join(tree, "mcmcpp_tpu_torch", "_build.py")
    spec = importlib.util.spec_from_file_location(f"wide_turns_{label}", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module.load_library()


def scratch_for(lib, p, dev):
    """A scratch buffer for ``lib``'s wide entry at width p, or None where
    its entry takes none (a checkout before route 4) or its route needs
    none."""
    if not hasattr(lib, "mcmcpp_fused_stretch_wide_split_l_f32"):
        return None
    out = (ctypes.c_int * 10)()
    if lib.mcmcpp_fused_stretch_wide_layout(p, out):
        raise RuntimeError(f"P={p}: layout failed")
    return torch.empty(max(out[9], 4) // 4, device=dev)


def main():
    if not torch.cuda.is_available():
        raise SystemExit("wide_turns.py needs a CUDA device")
    args = sys.argv[1:]
    iters = 20
    check = "--no-check" not in args
    args = [a for a in args if a != "--no-check"]
    if "--iters" in args:
        at = args.index("--iters")
        iters = int(args[at + 1])
        del args[at:at + 2]
    widths = [int(x) for x in args[0].split(",")]
    trees = [os.path.abspath(t) for t in args[1:]]
    sys.path.insert(0, ROOT)
    from mcmcpp_tpu_torch.models.targets import GaussianTarget
    from mcmcpp_tpu_torch.ops import fused_stretch as fs
    from mcmcpp_tpu_torch.ops.random import philox_unit_uniforms

    torch.backends.cuda.matmul.allow_tf32 = False
    libs = {os.path.relpath(t, ROOT): load(t, f"tree{i}")
            for i, t in enumerate(trees)}
    libs["this"] = load(ROOT, "this")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()
    dev = torch.device("cuda")
    blocker = torch.empty(1 << 28, device=dev)
    stream = torch.cuda.current_stream().cuda_stream
    n = 1 << 20

    def timed(fn):
        for _ in range(3):
            fn()
        torch.cuda.synchronize()
        for _ in range(16):
            blocker.zero_()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(iters):
            fn()
        end.record()
        torch.cuda.synchronize()
        return start.elapsed_time(end) / iters

    for p in widths:
        rng = np.random.default_rng(p)
        a = rng.normal(size=(p, p))
        cov = a @ a.T / p + np.eye(p)
        target = GaussianTarget(
            np.linalg.cholesky(np.linalg.inv(cov)).astype(np.float32),
            device=dev)
        g = torch.Generator(device=dev).manual_seed(p)
        act = 3.0 * torch.randn((n, p), generator=g, device=dev)
        other = torch.randn((n, p), generator=g, device=dev)
        other[::4] *= 10.0
        lp = target(act)
        shift = torch.tensor([n - 100], dtype=torch.int32, device=dev)
        key = 12345 + p
        u, ue = philox_unit_uniforms(key, n, dev)
        want = fs.fused_stretch_half_reference(act, lp, other, shift, u, ue,
                                               logp_fn=target)
        outs = (torch.empty_like(act), torch.empty_like(lp),
                torch.empty(n, dtype=torch.int32, device=dev))

        def caller(lib, entry):
            scratch = scratch_for(lib, p, dev)
            extra = () if scratch is None else (scratch.data_ptr(),)

            def call():
                err = entry(act.data_ptr(), lp.data_ptr(), other.data_ptr(),
                            shift.data_ptr(), key, target.prec_chol.data_ptr(),
                            outs[0].data_ptr(), outs[1].data_ptr(),
                            outs[2].data_ptr(), n, 0, n, p, 2.0, stream,
                            *extra)
                if err:
                    raise RuntimeError(f"P={p}: cudaError {err}")
            return call

        calls = {}
        for label, lib in libs.items():
            calls[label] = caller(lib, lib.mcmcpp_fused_stretch_wide_f32)
            calls[label]()
            torch.cuda.synchronize()
            if not check and label != "this":
                continue
            same = outs[2] == want[2]
            rel = ((outs[1][same] - want[1][same]).abs()
                   / want[1][same].abs().clamp(min=1.0)).max()
            if int((~same).sum()) > 5 or float(rel) > 1e-5:
                raise AssertionError(f"P={p} {label}: {int((~same).sum())} "
                                     f"masks differ, logp rel {float(rel)}")
        route = fs.WIDE_ROUTES[fs.wide_layout(p, dev)["route"]]
        if route.startswith("wgmma"):
            # the loads-only entry of this checkout and of every other that
            # takes the same route (one with route 4's scratch entry)
            # (one with route 4's scratch entry, or with route 6's forced
            # mma.sync entry)
            since = {fs.WIDE_ROUTES[4]: "mcmcpp_fused_stretch_wide_split_l_f32",
                     fs.WIDE_ROUTES[6]:
                         "mcmcpp_fused_stretch_wide_forced_mma_f32"}
            for label, lib in libs.items():
                if label == "this" or (route in since
                                       and hasattr(lib, since[route])):
                    calls[f"{label}_loads_only"] = caller(
                        lib, lib.mcmcpp_fused_stretch_wide_loads_only_f32)
        order = list(calls) + list(reversed(list(calls)))
        readings = {}
        for name in order:
            readings.setdefault(name, []).append(timed(calls[name]))
        print(f"P={p} ({route}) ms a launch, in turns: "
              + ", ".join(f"{k} {v[0]:.4f} {v[1]:.4f}"
                          for k, v in readings.items())
              + f" [{card}]", flush=True)
        del act, other, lp, want, u, ue, outs
        torch.cuda.empty_cache()


if __name__ == "__main__":
    main()
