"""The port's entry points over several processes: `python -m
spn4cir_tpu_torch.cli.train clip --distributed --mesh_bank 2` and `cli.
validate --distributed --mesh_data 2` as two gloo processes on the CPU,
launched with the `SPN4CIR_DIST_*` variables, against one process; the
initialization gate; and what the CLIs still refuse under a mesh, as the
JAX CLI does (`--neg_num`, `--mesh_bank` with `--wo_bank`) or because a
process started alone cannot hold a mesh.

Each pair of processes runs under a watchdog of 120 s: on timeout both are
killed and the test fails with their output. Mirrors
`tests/test_distributed.py`.
"""

import json
import os
import subprocess
import sys
import time

import pytest

from spn4cir_tpu_torch.cli.train import train_main
from spn4cir_tpu_torch.cli.validate import validate_main
from spn4cir_tpu_torch.parallel import mesh as pm
from tests.fixtures import make_cirr
from torch_fixtures import synthetic_tokenizer, write_merges_file

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ARGV = ["--dataset", "cirr", "--clip-model-name", "test-tiny", "--device",
        "cpu", "--batch-size", "4", "--num-epochs", "1", "--seed", "0"]
TIMEOUT = 120


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    base = tmp_path_factory.mktemp("dist_cli")
    return {"cirr": make_cirr(str(base / "cirr"), n_images=16, n_train=16,
                              n_val=8, extended=False),
            "merges": write_merges_file(str(base / "merges.txt.gz")),
            "base": base}


def _launch(module, argv, merges, n=2):
    """`python -m module argv` as n gloo processes; returns their stdout.
    On timeout every process is killed and the test fails."""
    port = pm.free_port()
    procs = []
    for rank in range(n):
        env = {**os.environ, "SPN4CIR_DIST_COORDINATOR": f"localhost:{port}",
               "SPN4CIR_DIST_NPROCS": str(n),
               "SPN4CIR_DIST_PROC_ID": str(rank),
               "SPN4CIR_BPE_VOCAB": merges, "OMP_NUM_THREADS": "1",
               "PYTHONPATH": REPO}
        env.pop("JAX_PLATFORMS", None)
        procs.append(subprocess.Popen(
            [sys.executable, "-m", module, *argv], cwd=REPO, env=env,
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=TIMEOUT)[0])
    except subprocess.TimeoutExpired:
        for p in procs:
            p.kill()
        logs = [p.communicate()[0][-3000:] for p in procs]
        pytest.fail(f"{module} did not finish in {TIMEOUT} s:\n"
                    + "\n".join(logs))
    for rank, (p, out) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, f"rank {rank} failed:\n{out[-4000:]}"
    return outs


def _start(module, argv, merges, tmp_path, n=2):
    """`python -m module argv` as n gloo processes left running, their
    output in files; returns (processes, log paths)."""
    port = pm.free_port()
    procs, logs = [], []
    for rank in range(n):
        env = {**os.environ, "SPN4CIR_DIST_COORDINATOR": f"localhost:{port}",
               "SPN4CIR_DIST_NPROCS": str(n),
               "SPN4CIR_DIST_PROC_ID": str(rank),
               "SPN4CIR_BPE_VOCAB": merges, "OMP_NUM_THREADS": "1",
               "PYTHONPATH": REPO}
        env.pop("JAX_PLATFORMS", None)
        logs.append(str(tmp_path / f"rank{rank}.log"))
        with open(logs[-1], "w") as out:
            procs.append(subprocess.Popen(
                [sys.executable, "-m", module, *argv], cwd=REPO, env=env,
                stdout=out, stderr=subprocess.STDOUT, text=True))
    return procs, logs


def _read(path):
    with open(path) as f:
        return f.read()[-4000:]


def _mean_losses(text):
    """The epochs' mean losses the training CLI prints (4 decimals)."""
    return [float(line.rsplit(" ", 1)[1]) for line in text.splitlines()
            if line.startswith("epoch ") and ": mean loss " in line]


def _losses(text):
    return [json.loads(line)["loss"] for line in text.splitlines()
            if line.startswith('{"step"')]


def test_train_cli_two_gloo_processes_match_one(world, tmp_path, capsys):
    """`cli.train clip --distributed --mesh_bank 2`: the bank's rows split
    over two ranks; rank 0 alone logs and writes best.pt; the losses are
    the single process's."""
    argv = ARGV + ["--data_path", world["cirr"]]
    outs = _launch("spn4cir_tpu_torch.cli.train",
                   ["clip", *argv, "--distributed", "--mesh_bank", "2",
                    "--output_path", str(tmp_path / "dist")],
                   world["merges"])
    got = _losses(outs[0]) + _mean_losses(outs[0])
    assert got and not _losses(outs[1]) + _mean_losses(outs[1])
    assert "mesh: data=1 bank=2 model=1" in outs[0]
    assert os.path.exists(tmp_path / "dist" / "best.pt")
    train_main("clip", argv + ["--output_path", str(tmp_path / "one")],
               tokenizer=synthetic_tokenizer())
    text = capsys.readouterr().out
    want = _losses(text) + _mean_losses(text)
    assert len(got) == len(want) == 2    # step 0, and the epoch's mean
    for a, b in zip(got, want):
        assert a == pytest.approx(b, rel=1e-5, abs=5e-5)


@pytest.mark.parametrize("flags", [["--mesh_data", "2"],
                                   ["--wo_bank", "--mesh_data", "2"]])
def test_train_cli_data_axis_matches_one(world, tmp_path, capsys, flags):
    """`cli.train clip --mesh_data 2`: each rank decodes and encodes half
    of every bank-extraction batch (stage 2) or of every training batch
    (stage 1, `--wo_bank`, the in-batch loss over the gathered batch); the
    losses are the single process's."""
    argv = ARGV + ["--data_path", world["cirr"]] + flags[:-2]
    outs = _launch("spn4cir_tpu_torch.cli.train",
                   ["clip", *argv, *flags[-2:],
                    "--output_path", str(tmp_path / "dist")],
                   world["merges"])
    got = _losses(outs[0]) + _mean_losses(outs[0])
    assert "mesh: data=2 bank=1 model=1" in outs[0]
    train_main("clip", argv + ["--output_path", str(tmp_path / "one")],
               tokenizer=synthetic_tokenizer())
    text = capsys.readouterr().out
    want = _losses(text) + _mean_losses(text)
    assert len(got) == len(want) == 2
    for a, b in zip(got, want):
        assert a == pytest.approx(b, rel=1e-5, abs=5e-5)


def test_serve_cli_mesh_model_answers_over_http(world, tmp_path):
    """`cli.serve --mesh_model 2`: the two ranks encode the gallery with
    the towers cut in two; rank 1 then exits and rank 0 serves alone with
    the whole backbone. Its answer over HTTP is the single process's."""
    import urllib.request

    from spn4cir_tpu_torch.cli.serve import serve_main

    argv = ARGV + ["--data_path", world["cirr"], "--serve_host",
                   "127.0.0.1"]
    server, service = serve_main(argv + ["--serve_port", "0", "--no-block"],
                                 tokenizer=synthetic_tokenizer())
    try:
        name = service.index.names[0]
        want = service.query_by_name(name, "make it red", k=3)
    finally:
        server.shutdown()
        server.server_close()
    port = pm.free_port()
    procs, logs = _start("spn4cir_tpu_torch.cli.serve",
                         ["clip", *argv, "--mesh_model", "2",
                          "--serve_port", str(port)],
                         world["merges"], tmp_path)
    try:
        assert procs[1].wait(TIMEOUT) == 0, _read(logs[1])
        deadline = time.monotonic() + TIMEOUT
        while "serving on" not in _read(logs[0]):
            assert procs[0].poll() is None, _read(logs[0])
            assert time.monotonic() < deadline, _read(logs[0])
            time.sleep(0.2)
        req = urllib.request.Request(
            f"http://127.0.0.1:{port}/retrieve",
            data=json.dumps({"reference_name": name,
                             "caption": "make it red", "k": 3}).encode(),
            headers={"Content-Type": "application/json"})
        got = json.loads(
            urllib.request.urlopen(req, timeout=60).read())["results"]
    finally:
        for p in procs:
            p.kill()
            p.wait()
    assert [r["name"] for r in got] == [r["name"] for r in want]
    for a, b in zip(got, want):
        assert a["score"] == pytest.approx(b["score"], abs=1e-5)


def test_validate_cli_two_gloo_processes_match_one(world):
    """`cli.validate --distributed --mesh_data 2`: the gallery encode split
    over two ranks (`extract_index_features(mesh=)`); rank 0 prints the
    metrics, the single process's."""
    argv = ARGV + ["--data_path", world["cirr"]]
    outs = _launch("spn4cir_tpu_torch.cli.validate",
                   ["clip", *argv, "--distributed", "--mesh_data", "2"],
                   world["merges"])
    text = outs[0][outs[0].index("{\n"):]
    got = json.loads(text[:text.index("\n}") + 2])
    assert "recall_at1" not in outs[1]
    want = validate_main("clip", argv, tokenizer=synthetic_tokenizer())
    assert got == pytest.approx(want, abs=1e-9)


def test_initialize_distributed_needs_its_gate(monkeypatch):
    """torchrun's variables alone do not open the gate."""
    for var in ("SPN4CIR_DISTRIBUTED", "SPN4CIR_DIST_COORDINATOR",
                "SPN4CIR_DIST_NPROCS", "SPN4CIR_DIST_PROC_ID"):
        monkeypatch.delenv(var, raising=False)
    monkeypatch.setenv("WORLD_SIZE", "2")
    monkeypatch.setenv("RANK", "1")
    assert pm.initialize_distributed() is False
    monkeypatch.setenv("SPN4CIR_DISTRIBUTED", "1")
    monkeypatch.setenv("WORLD_SIZE", "2")
    monkeypatch.delenv("MASTER_ADDR", raising=False)
    with pytest.raises(RuntimeError, match="coordinator"):
        pm.initialize_distributed()


@pytest.mark.parametrize("flags,match", [
    (["--wo_bank", "--mesh_bank", "2"], "no bank axis"),
    (["--neg_num", "3", "--mesh_bank", "2"], "full-bank"),
    (["--resume", "--mesh_model", "2"], "not checkpointed"),
    (["--mesh_data", "2"], "multi-process launch"),
    (["--distributed"], "multi-process launch"),
])
def test_train_cli_refuses_under_a_mesh(world, tmp_path, monkeypatch, flags,
                                        match):
    for var in ("SPN4CIR_DIST_NPROCS", "WORLD_SIZE"):
        monkeypatch.delenv(var, raising=False)
    with pytest.raises(SystemExit, match=match):
        train_main("clip", ARGV + ["--data_path", world["cirr"],
                                   "--output_path", str(tmp_path)] + flags,
                   tokenizer=synthetic_tokenizer())
