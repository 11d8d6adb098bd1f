"""``python -m disco_tpu_torch.cli.serve --device cpu`` as a real process:
one client session over a unix socket, its stream bit-identical to the
offline ``streaming_tango`` of the same clip (serving's contract), the
status frame judged and rendered by both packages' ``disco-obs`` alike,
and a SIGINT that drains the server and exits it with 0.

The server process runs on one torch and one BLAS thread, as this module
does (``torch_port_helpers.one_host_thread``), so both compute the offline
reference's arithmetic in the same order."""
import json
import os
import signal
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import pytest

from disco_tpu.cli import obs as jobs
from disco_tpu_torch.cli import obs as tobs
from disco_tpu_torch.serve import ServeClient
from disco_tpu_torch.serve import check as sc
from disco_tpu_torch.serve.status import fetch_status
from tests.torch_port_helpers import one_host_thread  # noqa: F401 (a fixture)

pytestmark = pytest.mark.usefixtures("one_host_thread")

ROOT = Path(__file__).resolve().parents[1]
ONE_THREAD = {"OMP_NUM_THREADS": "1", "MKL_NUM_THREADS": "1", "OPENBLAS_NUM_THREADS": "1"}


def _wait_for(path: Path, proc, timeout_s: float = 90.0) -> None:
    t0 = time.monotonic()
    while not path.exists():
        if proc.poll() is not None:
            raise AssertionError(f"server exited {proc.returncode}: {proc.stderr.read()}")
        if time.monotonic() - t0 > timeout_s:
            raise AssertionError("server did not bind in time")
        time.sleep(0.05)


def test_serve_process_stream_slo_and_sigint_drain(tmp_path, capsys):
    Y, m = sc.scene(31, device="cpu")
    ref = sc.offline_stream(Y, m, device="cpu")  # before the server starts
    sock, log = tmp_path / "serve.sock", tmp_path / "serve.jsonl"
    proc = subprocess.Popen(
        [sys.executable, "-m", "disco_tpu_torch.cli.serve", "--device", "cpu",
         "--unix", str(sock), "--obs-log", str(log), "--state-dir", str(tmp_path / "state")],
        cwd=ROOT, env={**os.environ, **ONE_THREAD, "PYTHONUNBUFFERED": "1"},
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    try:
        _wait_for(sock, proc)
        cl = ServeClient(str(sock))
        cl.open(sc.session_config(Y.shape[-2]))
        # one block in flight: a block's queue wait is then the server's
        # pickup, not the blocks sent ahead of it times the plain versions'
        # block time, which a loaded host stretches past the 500-ms SLO
        got = cl.enhance_clip(Y, m, m, window=1)
        cl.close()
        cl.shutdown()
        assert got.dtype == ref.dtype and np.array_equal(got, ref)

        status = fetch_status(str(sock))
        saved = tmp_path / "status.json"
        saved.write_text(json.dumps(status))
        capsys.readouterr()
        for targets in ([], ["--serve-p95-ms", "1e9", "--max-evict-rate", "1"]):
            want = jobs.main(["slo", str(saved)] + targets)
            printed = capsys.readouterr().out
            assert tobs.main(["slo", str(saved)] + targets + ["--device", "cpu"]) == want
            assert capsys.readouterr().out == printed and "SLO VERDICT: OK" in printed
        with pytest.raises(SystemExit) as e:
            tobs.main(["slo", str(sock), "--serve-p95-ms", "1e-9", "--device", "cpu"])
        assert e.value.code == 1
        assert tobs.render_status(status) == jobs.render_status(status)
        live = tobs.main(["top", str(sock), "--device", "cpu"])
        assert live["type"] == status["type"]

        proc.send_signal(signal.SIGINT)
        out, err = proc.communicate(timeout=90)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.communicate()
    assert proc.returncode == 0, err
    assert "disco-serve listening on" in out and "drained gracefully" in out
    summary = tobs.summarize(tobs.read_events(log))
    assert summary["manifest"]["tool"] == "disco-serve"
    assert summary["serve"]["sessions"].get("open") == 1
    assert summary["serve"]["serve_blocks"] == -(-Y.shape[-1] // sc.BLOCK)


def test_serve_refusals():
    from disco_tpu_torch.cli import serve as tserve

    with pytest.raises(SystemExit, match="--train needs --tap-dir"):
        tserve.main(["--train", "--device", "cpu"])
    with pytest.raises(SystemExit, match="--fault-seed needs --fault-spec"):
        tserve.main(["--fault-seed", "3", "--device", "cpu"])
