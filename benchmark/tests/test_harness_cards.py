"""A cell on several cards: the devices a run gets, the count of cards its
jobs used, the trace reduced per card, and a one-card cell run as a cell of
four over ``[cpu] * 4``, its program handed the list."""

import json

import pytest
import torch

from benchmark import run
from test_harness_drivers import SEED, tiny, window

FOUR = {"cell": {"chips": 4}}


def test_cell_devices():
    cpu = torch.device("cpu")
    assert run.cell_devices(cpu, 4) == [cpu] * 4
    assert run.cell_devices(torch.device("cuda", 0), 4) == [torch.device("cuda", i)
                                                            for i in range(4)]
    assert run.cell_devices([cpu, cpu], 4) == [cpu, cpu]
    assert run.cell_devices(None, 1) == [None]
    ctx = run.make_ctx("longunits.discover", SEED, cpu, None, FOUR)
    assert ctx.devices == [cpu] * 4 and ctx.device == cpu and ctx.program_device == [cpu] * 4
    one = run.make_ctx("longunits.discover", SEED, cpu, None)
    assert one.devices == [cpu] and one.program_device == cpu


def test_card_indices_and_cards_used():
    assert run.card_indices([torch.device("cuda", i) for i in (0, 1, 1, 3)]) == [0, 1, 3]
    assert run.card_indices([torch.device("cpu")] * 4) == []
    assert run.cards_used([10, 5, 7, 7], [12, 5, 9, 7]) == 2
    assert run.cards_used([3], [4]) == 1
    assert run.cards_used([3, 3], [3, 3]) == 0


def test_fewer_cards_than_the_cell_asks_for(monkeypatch, capsys):
    load = run.load_json

    def four_chips(path):
        data = load(path)
        for w in data.get("workloads", []) if isinstance(data, dict) else []:
            w["chips"] = 4
        return data

    monkeypatch.setattr(run, "load_json", four_chips)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    assert run.main(["--workload", "longunits.discover", "--seed", "1", "--seconds", "1"]) == 2
    assert capsys.readouterr().out == ""


def _event(name, cat, ts, dur, device=None):
    e = {"ph": "X", "name": name, "cat": cat, "ts": ts, "dur": dur}
    if device is not None:
        e["args"] = {"device": device, "stream": 7}
    return e


ONE_CARD = [
    _event("bench.job", "user_annotation", 0, 1000),
    _event("A", "kernel", 100, 200, 0),
    _event("A", "kernel", 250, 100, 0),
    _event("Memcpy HtoD", "gpu_memcpy", 500, 100, 0),
    _event("aten::foo", "cpu_op", 350, 150),
]


def _reduced(tmp_path, events, **kw) -> dict:
    from benchmark.trace import reduce_trace

    path = tmp_path / "trace.json"
    path.write_text(json.dumps({"traceEvents": events}))
    return reduce_trace(path, **kw)


def test_one_card_trace_keeps_its_numbers(tmp_path):
    """One card: every key a run read before cards were counted, with the
    same value, and only the per-card keys added."""
    got = _reduced(tmp_path, ONE_CARD)
    a_s = 200 / 1e6 + 100 / 1e6
    assert got == {
        "window_s": 1000 / 1e6,
        "busy_s": 350 / 1e6,
        "kernel_s": 300 / 1e6,
        "device_ops": [["A", a_s], ["Memcpy HtoD", 100 / 1e6]],
        "idle_gaps": [["host", 400 / 1e6], ["host: aten::foo", 150 / 1e6],
                      ["host", 100 / 1e6]],
        "busy_s_by_device": [350 / 1e6],
        "device_ops_by_device": [[["A", a_s], ["Memcpy HtoD", 100 / 1e6]]],
    }
    # Whatever index the profiler gives the one card.
    moved = [dict(e, args={"device": 3}) if "args" in e else e for e in ONE_CARD]
    assert _reduced(tmp_path, moved) == got


def test_four_card_trace_per_card(tmp_path):
    events = ONE_CARD + [_event("B", "kernel", 0, 500, 1), _event("A", "kernel", 200, 200, 2),
                         _event("B", "kernel", 300, 300, 2)]
    got = _reduced(tmp_path, events, cards=[0, 1, 2, 3])
    assert got["busy_s_by_device"] == [350 / 1e6, 500 / 1e6, 400 / 1e6, 0.0]
    assert got["busy_s"] == pytest.approx(1250 / 4 / 1e6, rel=1e-12)
    ops = [[[n, pytest.approx(t, rel=1e-12)] for n, t in card]
           for card in ([["A", 300 / 1e6], ["Memcpy HtoD", 100 / 1e6]], [["B", 500 / 1e6]],
                        [["B", 300 / 1e6], ["A", 200 / 1e6]], [])]
    assert got["device_ops_by_device"] == ops
    assert got["device_ops"] == [[n, pytest.approx(t, rel=1e-12)] for n, t in
                                 [["B", 800 / 1e6], ["A", 500 / 1e6], ["Memcpy HtoD", 100 / 1e6]]]
    assert got["kernel_s"] == pytest.approx(1300 / 1e6, rel=1e-12)
    # Idle gaps are those of every card together: only after 600 us.
    assert got["idle_gaps"] == [["host", 400 / 1e6]]


# Each driver's call into the program, the keyword that takes the list, and
# the cell's CPU size as a cell of four.  longunits: four clips of 4 s, units
# of a few hundred frames on the per-pair route (the plain twin, not K8's,
# which takes seconds a pair on the CPU), one clip a spectrogram group, so the
# groups and the pairs' blocks go round-robin over the four; a job takes 2-8 s
# on a loaded CPU, so the window is 15 s.
PROGRAM = {
    "longunits.discover": ("audio_pattern_discovery_tpu_torch.pipeline", "discover", "device",
                           {"corpus": {"n_clips": 4, "occurrences_per_clip": 1,
                                       "clip_seconds": 4.0, "motif_seconds": [1.5, 2.5]},
                            "pipeline": {"spectrogram.clip_batch": 1}}, 15.0),
    "config4.diag16": ("audio_pattern_discovery_tpu_torch.parallel.pair_scheduler",
                       "all_pairs_distances", "devices", None, None),
}


@pytest.mark.parametrize("name", sorted(PROGRAM))
def test_a_cell_of_four_hands_the_program_its_cards(monkeypatch, name):
    """The cell run as a cell of four over ``[cpu] * 4``: every call of the
    program gets the list, and the run is correct against the reference."""
    import importlib

    module, func, key, config, seconds = PROGRAM[name]
    mod = importlib.import_module(module)
    real, got = getattr(mod, func), []

    def spy(*args, **kw):
        got.append(kw.get(key))
        return real(*args, **kw)

    monkeypatch.setattr(mod, func, spy)
    over = tiny(name)
    over["cell"].update(FOUR["cell"])
    if config:
        over["config"] = config
    res, _ = run.run_cell(name, SEED, seconds or window(name), False, torch.device("cpu"),
                          overrides=over)
    assert res["correct"], res["checks"]
    assert got and all(d == [torch.device("cpu")] * 4 for d in got), got
    assert res["device"]["memory_peak_bytes_by_device"] == []
