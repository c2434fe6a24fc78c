"""The harness's whole run, the card's look skipped, with the timed path
broken underneath: ``correct`` has to come out false.  Also the control:
the plain reference in bfloat16 put in the program's place."""
import functools

import pytest
import torch

from portbench.reference import step as ref
from portbench.tests import tiny

UNIFORM = "sedov8.l4-s3-cap512"
AMR = "amr-sedov8.c16-s3-cap512"


def _assert_refused(result):
    assert result["correct"] is False
    assert any(c["value"] > c["limit"] for c in result["checks"].values())


def _bodies(monkeypatch, fault):
    """Wrap both hydro bodies the scenarios build, so every bucket's output
    passes through ``fault`` where it is produced."""
    import repro_torch.core.scenario as scenario

    def wrap(make):
        @functools.wraps(make)
        def made(*a, **kw):
            body = make(*a, **kw)

            def faulty(*args, out=None):
                res = body(*args)
                fault(res)
                return res if out is None else out.copy_(res)
            return faulty
        return made

    monkeypatch.setattr(scenario, "hydro_batched_body",
                        wrap(scenario.hydro_batched_body))
    monkeypatch.setattr(scenario, "level_batched_body",
                        wrap(scenario.level_batched_body))


def _half_left_out(res):
    res[res.shape[0] // 2:] = 0.0


def _one_answer_altered(res):
    """A sign error in each bucket's slot 0, at ``tiny.AMBIENT`` never a
    sub-grid that the blast touches."""
    res[0] = -res[0]


@pytest.mark.parametrize("name", (UNIFORM, AMR))
def test_state_returned_unchanged_is_refused(name):
    _assert_refused(tiny.run(name, program=tiny.program_of(
        name, step=lambda prog: (lambda u, dt: u))))


@pytest.mark.parametrize("name", (UNIFORM, AMR))
@pytest.mark.parametrize("fault", (_half_left_out, _one_answer_altered),
                         ids=("half_batch_left_out", "answer_altered"))
def test_broken_bucket_is_refused(monkeypatch, name, fault):
    """At a size with sub-grids far from the blast, where slot 0 of every
    bucket is one of them."""
    _bodies(monkeypatch, fault)
    _assert_refused(tiny.run(name, sizes=tiny.AMBIENT))


def test_slot_zero_lies_far_from_the_blast():
    """The uniform cell at ``tiny.AMBIENT``: the sub-grids that hold the
    blast's pressure are the centre 8, none of them slot 0 of a bucket."""
    from portbench.reference.grid import extract
    from portbench.scenarios.uniform_sedov import Cell

    _, config, mix = tiny.cell(UNIFORM, sizes=tiny.AMBIENT)
    cell = Cell(config, mix, torch.device("cpu"))
    u0 = cell.initial_state(tiny.SEED)
    energy = extract(u0, config["subgrid"], 0)[:, 4].amax(dim=(1, 2, 3))
    blast = set(torch.nonzero(energy > 10 * energy.median()).flatten()
                .tolist())
    assert blast == {21, 22, 25, 26, 37, 38, 41, 42}
    cap = mix["aggregation"]["max_aggregated"]
    assert not blast & set(range(0, cell.n_subgrids, cap))


def _bf16_uniform(prog):
    _, config, mix = tiny.cell(UNIFORM, sizes=tiny.AMBIENT)
    from portbench.scenarios.uniform_sedov import Cell
    g = Cell(config, mix, torch.device("cpu")).grid

    def step(u, dt):
        return ref.uniform_step(u.bfloat16(), dt.bfloat16(), g).float()
    return step


def _bf16_two_level(prog):
    _, config, mix = tiny.cell(AMR, sizes=tiny.AMBIENT)
    from portbench.scenarios.amr_sedov import Cell
    g = Cell(config, mix, torch.device("cpu")).grid

    def step(state, dt):
        uc, uf = ref.two_level_step(state[0].bfloat16(), state[1].bfloat16(),
                                    dt.bfloat16(), g)
        return uc.float(), uf.float()
    return step


@pytest.mark.parametrize("name,step", ((UNIFORM, _bf16_uniform),
                                       (AMR, _bf16_two_level)),
                         ids=("uniform", "two_level"))
def test_control_bf16_reference_in_the_program_place_is_refused(name, step):
    _assert_refused(tiny.run(name, sizes=tiny.AMBIENT, program=tiny.program_of(
        name, sizes=tiny.AMBIENT, step=step)))
