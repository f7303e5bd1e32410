"""The check's control and faults, on the CPU at a small size: the
reference put in the program's place one precision below the
configuration's must come out as not correct, and so must a run whose timed
path is broken underneath (a half-step that returns its state unchanged,
one that leaves half of the walkers out, one that alters an answer where it
is produced, a store that alters a stored element)."""

import sys
from pathlib import Path

import pytest
import torch

sys.path.insert(0, str(Path(__file__).resolve().parent.parent.parent))

from portbench.harness import catalog, runner  # noqa: E402

CELLS = catalog.names("workloads", ".json")
SMALL = {"walkers_log2": 9, "steps_per_call": 6}


@pytest.mark.parametrize("cell", CELLS)
def test_the_control_fails_a_number_of_every_cell(cell):
    r = runner.run_cell(cell, 2 ** 31 + 5, 0.2, device="cpu",
                        overrides=SMALL, control=True)
    assert r["correct"]
    limits = catalog.workload(cell)["limits"]
    failed = [k for k, v in r["control"].items() if v > limits[k]]
    assert failed, r["control"]


def _unchanged(inner):
    def half(active, active_logp, other, shift, *args, **kw):
        return (active, active_logp,
                torch.zeros(active.shape[0], dtype=torch.int32))
    return half


def _half_left_out(inner):
    def half(active, active_logp, other, shift, *args, **kw):
        rows, lp, acc = inner(active, active_logp, other, shift, *args, **kw)
        k = active.shape[0] // 2
        rows, lp, acc = rows.clone(), lp.clone(), acc.clone()
        rows[k:], lp[k:], acc[k:] = active[k:], active_logp[k:], 0
        return rows, lp, acc
    return half


def _answer_altered(inner):
    def half(active, active_logp, other, shift, *args, **kw):
        rows, lp, acc = inner(active, active_logp, other, shift, *args, **kw)
        rows = rows.clone()
        rows[3, 1] += 1e-3 * (1.0 + rows[3, 1].abs())
        return rows, lp, acc
    return half


def _logp_altered(inner):
    def half(active, active_logp, other, shift, *args, **kw):
        rows, lp, acc = inner(active, active_logp, other, shift, *args, **kw)
        lp = lp.clone()
        lp[5] += 1e-2 * (1.0 + lp[5].abs())
        return rows, lp, acc
    return half


FAULTS = {"unchanged": _unchanged, "half_left_out": _half_left_out,
          "answer_altered": _answer_altered, "logp_altered": _logp_altered}


@pytest.mark.parametrize("cell", CELLS)
@pytest.mark.parametrize("fault", sorted(FAULTS))
def test_a_broken_half_step_is_not_correct(cell, fault, monkeypatch):
    import mcmcpp_tpu_torch.movers.fused as fused

    monkeypatch.setattr(fused, "fused_stretch_half",
                        FAULTS[fault](fused.fused_stretch_half))
    r = runner.run_cell(cell, 2 ** 31 + 9, 0.2, device="cpu",
                        overrides=SMALL)
    assert not r["correct"], r["checks"]


def test_an_altered_stored_row_is_not_correct(monkeypatch):
    import mcmcpp_tpu_torch.chain as chain

    inner = chain.Chain.append

    def append(self, positions, logps=None):
        positions = positions.clone()
        positions[-1, 7, 2] = positions[-1, 7, 2] * 1.01 + 0.01
        return inner(self, positions, logps)

    monkeypatch.setattr(chain.Chain, "append", append)
    r = runner.run_cell("gauss10.store_bf16", 2 ** 31 + 3, 0.2,
                        device="cpu", overrides=SMALL)
    assert not r["correct"]
    assert r["checks"]["row_mismatch"]["value"] > 0
