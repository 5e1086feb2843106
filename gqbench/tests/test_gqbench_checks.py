"""The comparison that decides ``correct``, shown to fail: its control (the
reference in bfloat16 put in the program's place) reads above the limit on
three seeds for every cell, and a run with the timed path broken underneath
comes out not correct for each fault a cell can have, and for answers that
the policy's retry or ladder gave instead of the main path, where a sound
run comes out correct."""
import numpy as np
import pytest
import torch

from gqbench import control
from gqtiny import CELLS, cell, run


@pytest.mark.parametrize("name", CELLS)
def test_control_fails(name):
    for seed in (2**31 + 1, 2**31 + 2, 2**31 + 3):
        out = control.read_control(cell(name), seed, "cpu")
        assert out["fails"], out


def _unchanged(monkeypatch):
    """A hop that returns its state unchanged: the output as it was made."""
    from repro_torch.kernels import ops

    for fn in ("fragment_spmm", "fragment_spmm_packed", "fragment_spmm_fused"):
        orig = getattr(ops, fn)
        monkeypatch.setattr(ops, fn, lambda *a, _o=orig, **k: torch.zeros_like(_o(*a, **k)))


def _half_batch(monkeypatch):
    """Half of the batch left out, its rows the mean of the rest."""
    from repro_torch.robust import runner

    orig = runner.run_batch_with_policy

    def half(prepared, arrays, **kw):
        B = len(next(iter(arrays.values())))
        keep = max(1, B // 2)
        outs = orig(prepared, {k: v[:keep] for k, v in arrays.items()}, **kw)
        mean = np.mean([o.value for o in outs], axis=0)
        rest = [runner.QueryOutcome(outs[0].status, mean, outs[0].rung) for _ in range(B - keep)]
        return outs + rest

    monkeypatch.setattr(runner, "run_batch_with_policy", half)


def _altered(monkeypatch):
    """An answer altered where it is produced: every row's largest entry
    0.1% high in the batch the attempt returns."""
    from repro_torch.robust import runner

    orig = runner._attempt

    def attempt(*a, **k):
        out = orig(*a, **k)
        rows = np.arange(out.shape[0])
        out[rows, out.argmax(axis=1)] *= 1.001
        return out

    monkeypatch.setattr(runner, "_attempt", attempt)


def _retried(monkeypatch):
    """Every batch answered by the policy's retry, after a transient fault
    of its first attempt: a degraded answer, right in its values."""
    from repro_torch.robust import errors, runner

    orig = runner._attempt
    calls = []

    def attempt(*a, **k):
        calls.append(1)
        if len(calls) % 2:
            raise errors.ExecutionError("transient fault")
        return orig(*a, **k)

    monkeypatch.setattr(runner, "_attempt", attempt)


@pytest.mark.parametrize("name", CELLS)
def test_a_sound_run_is_correct(name):
    assert run(name)["correct"]


@pytest.mark.parametrize("fault", [_unchanged, _half_batch, _altered, _retried],
                         ids=lambda f: f.__name__[1:])
@pytest.mark.parametrize("name", CELLS)
def test_faults_are_caught(name, fault, monkeypatch):
    fault(monkeypatch)
    r = run(name)
    assert not r["correct"], r["checks"]
    if fault is _retried:
        gap = r["checks"]["max_rel_err"]
        assert r["checks"]["degraded"]["value"] > 0 and gap["value"] <= gap["limit"]
