"""The port's data-parallel trainer and command line, two ranks on the CPU
(gloo), against the JAX package's contract for its sharded trainer
(`naqs_tpu/trainer.py` `_step_sharded`, `tests/test_parallel.py`,
`tests/test_multihost.py`).

- `VMCTrainer(..., n_devices=2)` on LiH STO-3G (capacity 128 a rank):
  after 3 step()s of Adam (with the gradient clip), of Adam with exact local
  energies against the sector table split over the ranks, of SR and of
  K-FAC, every parameter, Adam moment and count, clip ring and K-FAC factor
  is bitwise the same on both ranks, and so are the logs (but for each
  rank's wall times); the merged buffer
  fed the sampled-state counter; rank 0 alone wrote files.
- A checkpoint holds every rank's generator: a resumed two-rank run draws
  different batches on each rank and repeats the uninterrupted run's steps
  bit for bit.
- The controller resamples on overflow: 10^6 samples overflow 128 rows a
  rank, the step is withheld, n_samples backs off and the step completes.
- A trainer of n_devices=2 without a process group of 2 raises.
- `python -m naqs_tpu_torch.cli -platform cpu -devices 2` trains H2 for a
  few steps through ranks it starts itself (one `log.jsonl`, rank 0's lines
  alone on stdout), and under a torchrun-style environment (MASTER_ADDR,
  MASTER_PORT, WORLD_SIZE, RANK: `initialize_distributed` reads env://) in
  two processes started here; both runs log the same energies as each other.
"""

import json
import os
import socket
import subprocess
import sys

import numpy as np
import pytest

import naqs_tpu_torch as nt
from naqs_tpu_torch.parallel.launch import spawn
from naqs_tpu_torch.utils.molecule import molecule_from_fields, save_molecule_npz
from test_torch_support import REPO, case, fields

import test_torch_parallel_ranks as ranks

D = 2
STEPS = 3
TIMEOUT = 240
BASE = dict(lr=1e-2, use_lr_schedule=False, n_samples=500.0, n_unq_samples_min=1,
            n_unq_samples_max=256, seed=3)
CASES = {
    "adam_clip": dict(BASE, grad_clip_factor=2.0),
    "adam_exact_eloc": dict(BASE, exact_eloc=True, eloc_fwd_chunk=64),
    "sr": dict(BASE, use_sr=True, sr_cg_iters=5, sr_damping=1e-2, lr=5e-2),
    "kfac": dict(BASE, use_kfac=True, lr=5e-2),
    "overflow": dict(BASE, n_samples=1e6),
}
CLI_ARGS = ["-platform", "cpu", "-devices", "2", "-n_train", "4", "-lr", "1e-2", "-n_hid",
            "16", "-n_samps", "1e5", "-n_unq_samps_min", "2", "-n_unq_samps_max", "16",
            "-output_freq", "1", "-s", "1"]


@pytest.fixture(scope="module")
def trained(tmp_path_factory):
    c = case("LiH")
    cfg_kw = dict(n_qubits=c.mol_t.n_qubits, sectors=c.h_t.sectors, amp_hidden=(16,),
                  phase_hidden=(16,))
    work = tmp_path_factory.mktemp("trainer")
    got = spawn(ranks.trainer_steps, D, (c.h_t, c.terms_t, cfg_kw, CASES, STEPS, str(work)),
                workdir=str(work), timeout=TIMEOUT)
    return got


@pytest.mark.parametrize("name", [k for k in CASES if k != "overflow"])
def test_sharded_trainer_state_stays_bitwise_replicated(trained, name):
    a, b = trained[0][name], trained[1][name]
    assert a["n_steps"] == b["n_steps"] == STEPS
    assert a["params"] == b["params"]
    assert a["state"] == b["state"] and (len(a["state"]) > 0) == (name != "sr")  # SR: none
    timeless = lambda log: {k: v for k, v in log.items() if k != "TIME"}  # each rank's clock
    assert timeless(a["log"]) == timeless(b["log"]) and a["n_samples"] == b["n_samples"]
    assert all(np.isfinite(r["e_loc"]) and r["n_unique"] > 0 for r in a["rows"])
    # steps 1 and 6, 11, ... feed the counter from the merged buffer
    assert a["counter"] == b["counter"] == a["rows"][0]["n_unique"] > 0
    assert "checkpoint.pt" in a["files"] and "log.jsonl" in a["files"] and b["files"] == []
    if name == "sr":
        assert all(r["cg_iters"] == 5 for r in a["rows"])


def test_sharded_trainer_resamples_on_overflow(trained):
    """The first attempts overflow 128 rows a rank and are withheld; the
    controller backs n_samples off until a step fits, and takes it."""
    for r in range(D):
        o = trained[r]["overflow"]
        assert o["n_steps"] == STEPS and o["ovf_n"] < 1e6
        assert o["n_samples"] <= o["ovf_n"] / 10
        assert all(np.isfinite(x["e_loc"]) for x in o["rows"])
    assert trained[0]["overflow"]["params"] == trained[1]["overflow"]["params"]


def test_sharded_trainer_resumes_each_rank_on_its_own_stream(tmp_path):
    """A checkpoint of a two-rank run holds each rank's generator: after
    load() the ranks draw different batches, each from the stream it had
    at the save, and the resumed run's steps are the uninterrupted run's,
    bit for bit (rows and parameters)."""
    c = case("LiH")
    cfg_kw = dict(n_qubits=c.mol_t.n_qubits, sectors=c.h_t.sectors, amp_hidden=(16,),
                  phase_hidden=(16,))
    got = spawn(ranks.trainer_resume, D, (c.h_t, c.terms_t, cfg_kw, CASES["adam_clip"], 2,
                                          str(tmp_path)), workdir=str(tmp_path), timeout=TIMEOUT)
    assert got[0]["saved"] != got[1]["saved"]
    assert not np.array_equal(got[0]["draw"], got[1]["draw"])
    for r in range(D):
        assert got[r]["loaded"] == got[r]["saved"]
        assert got[r]["resumed"] == got[r]["on"]
        assert got[r]["resumed_params"] == got[r]["on_params"]
    assert got[0]["on"] == got[1]["on"]


@pytest.mark.parametrize("saved_ranks", [None, 3])
def test_a_checkpoint_of_another_world_gives_each_rank_its_own_stream(saved_ranks):
    """A checkpoint without one generator a rank of this group (one device's,
    or another group size's) seeds each rank's stream from the saved one:
    distinct across ranks, the same on every load."""
    from types import SimpleNamespace

    import torch

    state = torch.Generator().manual_seed(5).get_state()
    ranks_states = None if saved_ranks is None else [state.clone()] * saved_ranks
    draws = {}
    for r in (0, 1, 0):
        t = SimpleNamespace(n_devices=2, rank=r, device=torch.device("cpu"),
                            gen=torch.Generator())
        nt.VMCTrainer._load_generator(t, state, ranks_states)
        draw = torch.rand(8, generator=t.gen)
        assert r not in draws or torch.equal(draws[r], draw)
        draws[r] = draw
    assert not torch.equal(draws[0], draws[1])


def test_sharded_trainer_needs_a_process_group():
    c = case("H2")
    cfg = nt.NAQSConfig(n_qubits=c.mol_t.n_qubits, sectors=c.h_t.sectors, amp_hidden=(8,),
                        phase_hidden=(8,))
    with pytest.raises(RuntimeError, match="process group"):
        nt.VMCTrainer(cfg, c.terms_t, c.h_t, nt.TrainConfig(), device="cpu", n_devices=2)


@pytest.fixture(scope="module")
def h2_npz(tmp_path_factory):
    path = tmp_path_factory.mktemp("mol") / "H2.npz"
    save_molecule_npz(molecule_from_fields(fields("H2"), load_hamiltonian=False), str(path))
    return str(path)


def _e_loc(out_dir):
    with open(os.path.join(out_dir, "log.jsonl")) as f:
        return [x["value"] for x in map(json.loads, f) if x["key"] == "E_LOC"]


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def test_cli_devices_2_on_the_cpu(h2_npz, tmp_path):
    """The CLI starts its two ranks itself, and under a torchrun-style
    environment runs as one of two ranks started here (env://)."""
    env = dict(os.environ, PYTHONPATH=REPO, OMP_NUM_THREADS="1")
    env.pop("XLA_FLAGS", None)
    run = lambda argv, e: subprocess.Popen(
        [sys.executable, "-m", "naqs_tpu_torch.cli", *argv], cwd=tmp_path, env=e,
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    own = run(CLI_ARGS + ["-m", h2_npz, "-o", str(tmp_path / "own")], env)
    port = _free_port()
    env_ranks = [run(CLI_ARGS + ["-m", h2_npz, "-o", str(tmp_path / "env")],
                     dict(env, MASTER_ADDR="localhost", MASTER_PORT=str(port),
                          WORLD_SIZE="2", RANK=str(r), LOCAL_RANK=str(r)))
                 for r in range(D)]
    outs = []
    try:
        for p in [own, *env_ranks]:
            outs.append(p.communicate(timeout=TIMEOUT)[0])
    finally:
        for p in [own, *env_ranks]:
            if p.poll() is None:
                p.kill()
                p.wait()
    for p, out in zip([own, *env_ranks], outs):
        assert p.returncode == 0, out[-3000:]
    assert outs[0].count("step 1:") == 1 and "---------- Summary" in outs[0]
    assert outs[2].count("step 1:") == 0   # rank 1 of the env:// run prints nothing
    for d in ("own", "env"):
        e = _e_loc(tmp_path / d)
        assert len(e) == 4 and np.isfinite(e).all()
        for name in ("args.json", "summary.json", "checkpoint.pt"):
            assert (tmp_path / d / name).exists(), (d, name)
        assert not [f for f in os.listdir(tmp_path / d) if f.startswith("rank_job")]
    assert _e_loc(tmp_path / "own") == _e_loc(tmp_path / "env")
