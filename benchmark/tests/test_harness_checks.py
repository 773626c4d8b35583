"""The check fails what it must: the control in the program's place, and
faults planted underneath the timed path, at a tiny size on the CPU; and,
on the card, the control at the cell's own size."""

import numpy as np
import pytest
import torch

from benchmark import run
from benchmark.control import readings
from benchmark.faults import BLOCK, _altered, planted
from test_harness_drivers import CELLS, SEED, cells_of, tiny, window


def failed(checks: dict, name: str) -> list[str]:
    cell = run.load_json(run.HERE / "workloads" / f"{name}.json")
    return [k for k, v in checks.items() if not v <= cell["limits"][k]]


@pytest.mark.parametrize("name", CELLS)
def test_control_is_not_correct(name):
    r = readings(name, SEED, torch.device("cpu"), tiny(name))
    assert not failed(r["sound"], name), r["sound"]
    assert failed(r["control"], name), r["control"]


@pytest.mark.card
@pytest.mark.parametrize("name", CELLS)
def test_control_on_the_card(card, name):
    chips = run.load_json(run.HERE / "workloads" / f"{name}.json")["chips"]
    if torch.cuda.device_count() < chips:
        pytest.skip(f"{name} runs on {chips} cards")
    r = readings(name, SEED + 1, card)
    assert not failed(r["sound"], name), r["sound"]
    assert failed(r["control"], name), r["control"]


@pytest.mark.parametrize("name", CELLS)
@pytest.mark.parametrize("fault", ["answer", "half", "block"])
def test_planted_fault_is_not_correct(name, fault):
    with planted(fault):
        res, _ = run.run_cell(name, SEED, window(name), False, torch.device("cpu"),
                              overrides=tiny(name))
    assert res["checks"] and not res["correct"], res["checks"]


@pytest.mark.parametrize("name", cells_of("discover"))
@pytest.mark.parametrize("fault", ["unchanged", "half_batch"])
def test_training_fault_is_not_correct(name, fault):
    with planted(fault):
        res, _ = run.run_cell(name, SEED, window(name), False, torch.device("cpu"),
                              overrides=tiny(name))
    assert res["checks"] and not res["correct"], res["checks"]


@pytest.mark.parametrize("name", cells_of("discover_pca"))
def test_embedding_fault_is_not_correct(name):
    with planted("unwhitened"):
        res, _ = run.run_cell(name, SEED, window(name), False, torch.device("cpu"),
                              overrides=tiny(name))
    assert res["checks"] and not res["correct"], res["checks"]


@pytest.mark.parametrize("K", [48, 300, 10240])
def test_drawn_pairs_cover_every_block(K):
    """Every block of BLOCK x BLOCK indices, on either side of the diagonal,
    holds a drawn pair or its mirror; so does the block the ``block`` fault
    alters."""
    from benchmark.traffic import all_pairs

    ctx = run.make_ctx("config4.diag16", SEED, torch.device("cpu"), None)
    lens = np.random.default_rng(1).integers(64, 129, K)
    ia, ib = all_pairs.drawn_pairs(ctx, lens)
    assert np.all(ia < ib) and np.all(ib < K) and len(ia) >= all_pairs.LEAST
    nb = -(-K // all_pairs.BLOCK)
    hit = np.zeros((nb, nb), bool)
    hit[ia // all_pairs.BLOCK, ib // all_pairs.BLOCK] = True
    assert hit[np.triu_indices(nb)].all()
    top = np.argsort(lens, kind="stable")[-2:]
    assert (min(top), max(top)) in set(zip(ia.tolist(), ib.tolist()))
    D = _altered(lambda: np.ones((K, K)), "block")()
    moved = np.argwhere(D != 1.0) // BLOCK
    assert len(moved) and all(hit[min(i, j), max(i, j)] for i, j in moved)
