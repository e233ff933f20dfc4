"""The comparison that decides ``correct`` fails what it must: the control
(the reference in TF32 in the program's place) and a run whose timed path
is broken underneath (a step that returns its state unchanged, the elastic
forces of half the particles left out and the rest doubled, an answer
altered where it is produced), at a size the CPU holds.  On one card the
cells have no exchange between chips to leave out.  The readings at the
cells' own sizes, from which the limits are set, come from
``benchmarks.calibrate`` on the card; at these few steps the program's own
f32 gradient is noisier than at the cells' depth, so the sound runs here
are held to reading far below the control and the faults instead."""

from __future__ import annotations

import pytest
import torch

from benchmarks import correct, inputs, run
from benchmarks.program import Program
from benchmarks.tests.conftest import small

CELLS = ["million.grad", "stretch112k_varcol.grad", "million.fwd"]


@pytest.mark.parametrize("name", CELLS)
def test_control_fails_and_the_program_reads_far_below_it(name):
    cell = small(name, 1200, 40)
    pts, n_outer, h, mask = inputs.body(cell.config)
    prog = Program(cell, pts, n_outer, h, mask, "cpu")
    ref = correct.Reference(cell, pts, h, mask, "cpu")
    ctl = ref.control()
    for seed in (1, 2, 3):
        x = inputs.smooth_field(torch.as_tensor(pts), cell.traffic["x"],
                                inputs.seed_generator(seed, "cpu"))
        want = ref.run(x)
        sound = correct.compare(prog.entry, prog.run(x), want, ref.rest)
        control = correct.compare(ctl.entry, ctl.run(x), want, ref.rest)
        ok, checks = correct.judge(control, cell.limits)
        assert not ok, checks
        assert all(sound[k] * 10 < control[k] for k in sound), (sound, control)


def _unchanged(monkeypatch):
    from softbody_tpu_torch.sim import rollout as ro

    monkeypatch.setattr(ro, "step", lambda state, *a, **k: state)


def _half(monkeypatch):
    from softbody_tpu_torch.sim import rollout as ro

    el = ro.elastic_forces

    def half(pos, *a, **k):
        f = el(pos, *a, **k)
        keep = (torch.arange(f.shape[0], device=f.device) % 2 == 0).to(f.dtype)
        return f * (2.0 * keep)[:, None]

    monkeypatch.setattr(ro, "elastic_forces", half)


def _altered(monkeypatch):
    from softbody_tpu_torch.sim import rollout as ro

    vg, fc = ro.episode_value_and_grad_chunked, ro.forward_chunked

    def alter_grad(*a, **k):
        f = vg(*a, **k)

        def g(*b):
            loss, grad = f(*b)
            grad = grad.clone()
            i = int(grad.abs().argmax())
            grad[i] = -grad[i]
            return loss, grad

        return g

    def alter_final(x, scene, *a, **k):
        final, rec = fc(x, scene, *a, **k)
        d = final.position - scene.rest_position
        i = int(d.norm(dim=1).argmax())
        pos = final.position.clone()
        pos[i] = scene.rest_position[i] - d[i]
        return final._replace(position=pos), rec

    monkeypatch.setattr(ro, "episode_value_and_grad_chunked", alter_grad)
    monkeypatch.setattr(ro, "forward_chunked", alter_final)


FAULTS = {"state_unchanged": _unchanged, "half_the_forces": _half,
          "answer_altered": _altered}


@pytest.fixture(scope="module")
def sound_runs():
    """The checks of a sound run of each small cell."""
    return {name: run.run_cell(small(name, 800, 30), 17, 0.1, False, "cpu")["checks"]
            for name in CELLS}


@pytest.mark.parametrize("fault", list(FAULTS))
@pytest.mark.parametrize("name", CELLS)
def test_broken_timed_path_is_not_correct(name, fault, monkeypatch, sound_runs):
    cell = small(name, 800, 30)
    FAULTS[fault](monkeypatch)
    r = run.run_cell(cell, 17, 0.1, False, "cpu")
    assert r["correct"] is False, r["checks"]
    sound = sound_runs[name]
    assert any(r["checks"][k]["value"] > 10 * sound[k]["value"] for k in sound), \
        (r["checks"], sound)


@pytest.mark.cuda
@pytest.mark.parametrize("name", CELLS[:2])
def test_cell_is_correct_on_the_card(name, cuda_device):
    """One short run of each cell at its own size on the card."""
    r = run.run_cell(run.spec.Cell(name), 2 ** 32 + 99, 1.0, False, cuda_device)
    assert r["correct"], r["checks"]
