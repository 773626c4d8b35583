"""The readers of the program's AE and start-up spans (``ae_step_ms.discover``,
``scaler_fit_s.discover``, ``first_use_s``) on fabricated runs: their
arithmetic, and None, never an exception, where a program records no such
span or registry (the parent of the change that added them)."""

import pytest

from benchmark import run as bench_run
from benchmark.run import HERE, Run


def reader(name: str):
    return bench_run.load_module(HERE / "metrics" / f"{name}.py").read


def job(timings: dict, counts: dict) -> dict:
    return {"t0": 0.0, "t1": 1.0, "work": 1, "stats": {"timings_s": timings, "counts": counts}}


def fabricated(*jobs) -> Run:
    return Run(ctx=None, setup_s=20.0, window_s=6.0, jobs=list(jobs))


def test_ae_step_ms_is_the_mean_of_each_runs_step():
    read = reader("ae_step_ms.discover")
    runs = fabricated(
        job({"autoencoder_train": 1.9, "autoencoder_train.steps": 1.4}, {"ae_steps": 560.0}),
        job({"autoencoder_train": 2.3, "autoencoder_train.steps": 1.96}, {"ae_steps": 560.0}),
    )
    assert read(runs) == pytest.approx((2.5 + 3.5) / 2)


@pytest.mark.parametrize("name", ["ae_step_ms.discover", "scaler_fit_s.discover"])
def test_span_readers_find_nothing_in_a_program_without_the_spans(name):
    # The parent's stats: the AE stage whole, no children, no step count.
    old = fabricated(job({"autoencoder_train": 1.9, "dtw": 0.01}, {"ae_train_frames": 26335.0}))
    assert reader(name)(old) is None
    # The two-phase path's span ends at the enqueue: no step time is read
    # from it.
    enq = fabricated(job({"autoencoder_train.steps_enqueued": 0.9}, {"ae_steps": 560.0}))
    assert reader("ae_step_ms.discover")(enq) is None


def test_scaler_fit_s_is_the_mean_over_the_runs():
    read = reader("scaler_fit_s.discover")
    runs = fabricated(job({"autoencoder_train.scaler_fit": 0.2}, {}),
                      job({"autoencoder_train.scaler_fit": 0.26}, {}),
                      job({"dtw": 0.01}, {}))
    assert read(runs) == pytest.approx(0.23)


def test_first_use_s_sums_the_outermost_keys(monkeypatch):
    from audio_pattern_discovery_tpu_torch.utils import logging as apd_logging

    reg = apd_logging.StageCounters()
    reg.timings_s.update({"kernel_build": 21.0, "kernel_build.dtw_tile": 20.5,
                          "kernel_build.dtw_lane_diag": 21.0, "kernel_load": 0.2,
                          "kernel_load.dtw_tile": 0.1, "native_load": 0.05,
                          "native_load.build": 0.04, "optimizer_first_use": 5.9})
    reg.add("kernel_builds", 2)
    monkeypatch.setattr(apd_logging, "FIRST_USE", reg)
    assert reader("first_use_s")(fabricated()) == pytest.approx(21.0 + 0.2 + 0.05 + 5.9)


def test_first_use_s_is_none_without_the_registry(monkeypatch):
    from audio_pattern_discovery_tpu_torch.utils import logging as apd_logging

    monkeypatch.delattr(apd_logging, "FIRST_USE")
    assert reader("first_use_s")(fabricated()) is None


def test_dtw_long_roofline_counts_every_cell_of_every_pair():
    """K8's share: the cells of every pair (la x lb, unbanded) at 3d+4 fp32
    operations over 67 TFLOP/s, over the device time of the kernels named
    ``long_block_kernel`` a traced job."""
    lens = [4284, 5000, 8192, 6001, 4284]
    ctx = bench_run.make_ctx("longunits.discover", 1, None, None)
    stats = {"timings_s": {}, "counts": {"feature_dim": 16.0}, "lengths": lens}
    trace = {"device_ops": [["void long_block_kernel<4, 4, true, false>(...)", 0.03],
                            ["void long_block_kernel<2, 4, true, false>(...)", 0.01],
                            ["Memcpy HtoD (Pageable -> Device)", 0.5]]}
    runs = Run(ctx, 20.0, 12.0, [{"stats": stats}, {"stats": stats}], trace)
    cells = sum(lens[i] * lens[j] for i in range(5) for j in range(i + 1, 5))
    least = cells * (3 * 16 + 4) / 67e12
    assert reader("dtw_long_roofline.discover")(runs) == pytest.approx(
        100.0 * 2 * least / 0.04, rel=1e-12)
    # Nothing to read: no trace, or no K8 kernel in it (the CPU's twin).
    assert reader("dtw_long_roofline.discover")(Run(ctx, 20.0, 12.0, [{"stats": stats}])) is None
    trace["device_ops"] = trace["device_ops"][2:]
    assert reader("dtw_long_roofline.discover")(runs) is None


def test_embedding_s_sums_fit_and_encode():
    read = reader("embedding_s.discover")
    runs = fabricated(job({"embedding_fit": 0.3, "embedding_encode": 0.1}, {}),
                      job({"embedding_fit": 0.5, "embedding_encode": 0.1}, {}))
    assert read(runs) == pytest.approx(0.5)
    assert read(fabricated(job({"autoencoder_train": 1.9}, {}))) is None
