"""The port's resident worker (serve.py, the CLI's --serve): the socket
protocol, fault isolation and output parity with the direct library calls,
with a --device cpu worker in a subprocess, as a user starts it."""

import json
import os
import socket
import subprocess
import sys
import threading
import time
from pathlib import Path

import numpy as np
import pytest
import torch

from audio_pattern_discovery_tpu_torch.config import PipelineConfig
from audio_pattern_discovery_tpu_torch.pipeline import discover
from audio_pattern_discovery_tpu_torch.query import query_corpus
from audio_pattern_discovery_tpu_torch.serve import request, serve
from audio_pattern_discovery_tpu_torch.synthetic import make_corpus

torch.set_num_threads(1)

REPO = Path(__file__).resolve().parent.parent


def _cfg() -> PipelineConfig:
    cfg = PipelineConfig()
    cfg.spectrogram.sample_rate = 16_000
    cfg.spectrogram.win_length = 256
    cfg.spectrogram.hop_length = 128
    cfg.spectrogram.max_bins = 64
    cfg.segmentation.threshold_db = -25.0
    cfg.segmentation.min_len_frames = 6
    cfg.segmentation.merge_gap_frames = 3
    cfg.autoencoder.enabled = False
    cfg.dtw.max_seq_len = 64
    cfg.dtw.pair_batch = 128
    cfg.output.write_images = False
    cfg.output.write_html_report = False
    return cfg


def _wait_for_ping(sock: Path, proc=None, timeout: float = 120.0) -> dict:
    deadline = time.time() + timeout
    while time.time() < deadline:
        if proc is not None and proc.poll() is not None:
            raise AssertionError(f"server died at start-up: {proc.stderr.read()[-3000:]}")
        try:
            return request(sock, {"cmd": "ping"}, timeout=10)
        except OSError:
            time.sleep(0.1)
    raise TimeoutError("server never answered ping")


def test_serve_end_to_end(tmp_path):
    corpus = tmp_path / "corpus"
    make_corpus(corpus, n_clips=6, n_motifs=2, clip_seconds=1.5, seed=3)
    sock = tmp_path / "apd.sock"
    cfg_dict = _cfg().to_dict()
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    proc = subprocess.Popen(
        [sys.executable, "-m", "audio_pattern_discovery_tpu_torch", "--serve", str(sock),
         "--device", "cpu"],
        cwd=REPO, env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
    )
    try:
        pong = _wait_for_ping(sock, proc)
        assert pong["ok"] and pong["result"]["device"] == "cpu"
        out_srv, out_lib = tmp_path / "out_srv", tmp_path / "out_lib"
        r = request(sock, {"cmd": "discover", "wav_dir": str(corpus), "out_dir": str(out_srv),
                           "config": cfg_dict}, timeout=300)
        assert r["ok"], r.get("traceback", r)
        assert r["result"]["n_clusters"] >= 1 and r["result"]["n_segments"] > 2
        direct = discover(corpus, PipelineConfig.from_dict(cfg_dict), out_dir=out_lib,
                          device="cpu")
        np.testing.assert_array_equal(np.load(out_srv / "distance_matrix.npy"),
                                      direct.distance_matrix)
        srv = json.loads((out_srv / "clusters.json").read_text())
        lib = json.loads((out_lib / "clusters.json").read_text())
        assert [c["members"] for c in srv["clusters"]] == [c["members"] for c in lib["clusters"]]

        # The same query twice on the warm worker, as the library answers it.
        qwav = sorted(corpus.glob("*.wav"))[0]
        want = query_corpus(out_srv, [qwav], PipelineConfig.from_dict(cfg_dict), top_k=3,
                            device="cpu")
        for _ in range(2):
            r = request(sock, {"cmd": "query", "out_dir": str(out_srv), "wavs": [str(qwav)],
                               "top_k": 3, "config": cfg_dict}, timeout=300)
            assert r["ok"], r.get("traceback", r)
            assert r["result"] == json.loads(json.dumps(want))

        # Bad requests do not kill the worker; doctor answers the report.
        r = request(sock, {"cmd": "no_such_cmd"}, timeout=30)
        assert not r["ok"] and "unknown cmd" in r["error"]
        r = request(sock, {"cmd": "discover", "wav_dir": str(corpus),
                           "out_dir": str(out_srv / "bad"), "config": cfg_dict,
                           "overrides": {"dtw.nonexistent_knob": 1}}, timeout=60)
        assert not r["ok"]
        r = request(sock, {"cmd": "doctor"}, timeout=60)
        assert r["ok"], r.get("traceback", r)
        assert set(r["result"]) == {"versions", "host", "native_lib", "compile_cache", "env"}
        assert request(sock, {"cmd": "ping"}, timeout=30)["ok"]

        r = request(sock, {"cmd": "shutdown"}, timeout=30)
        assert r["ok"]
        proc.wait(timeout=60)
        assert proc.returncode == 0
        assert json.loads(proc.stdout.read().strip().splitlines()[-1])["served"] == 9
        assert not sock.exists(), "socket file not cleaned up"
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait(timeout=30)


def test_serve_refuses_second_live_server(tmp_path):
    # Two workers on one socket would race for the device.
    sock = tmp_path / "apd.sock"
    t = threading.Thread(target=serve, args=(sock,),
                         kwargs={"max_requests": 2, "device": "cpu"}, daemon=True)
    t.start()
    assert _wait_for_ping(sock, timeout=30)["ok"]
    with pytest.raises(RuntimeError, match="already answering"):
        serve(sock, device="cpu")
    assert request(sock, {"cmd": "shutdown"}, timeout=10)["ok"]
    t.join(timeout=30)
    assert not t.is_alive()
    assert not sock.exists()


def test_serve_replaces_stale_socket(tmp_path):
    # A dead server's leftover socket file does not brick the path.
    sock = tmp_path / "apd.sock"
    s = socket.socket(socket.AF_UNIX, socket.SOCK_STREAM)
    s.bind(str(sock))
    s.close()   # bound then closed: the file remains, nothing answers
    served = []
    t = threading.Thread(target=lambda: served.append(serve(sock, max_requests=1, device="cpu")),
                         daemon=True)
    t.start()
    assert _wait_for_ping(sock, timeout=30)["ok"]
    t.join(timeout=30)
    assert not t.is_alive()
    assert served == [1]
