"""The port's CLI against naqs_tpu.cli: the same flags (names, defaults,
types, choices, actions), the same parsed values and experiment names, the
same JSONL log lines; H2 trained to chemical accuracy through
`python -m naqs_tpu_torch.cli -platform cpu`; the unported flags refused with
their ROADMAP item; no silent move to the CPU."""

import json
import os
import subprocess
import sys

import pytest
import torch

from naqs_tpu import cli as cli_j
from naqs_tpu.utils import profiling as profiling_j
from naqs_tpu_torch import cli as cli_t
from naqs_tpu_torch.utils import profiling as profiling_t
from naqs_tpu_torch.utils.molecule import molecule_from_fields, save_molecule_npz
from test_torch_support import REPO, fields

ARGVS = [
    [],
    ["-m", "LiH", "-n_train", "2000", "-n_hid", "64", "-single_phase"],
    ["-m", "H2O_6-31G_gen", "-n_hid", "64", "-single_phase", "-n_hid_phase", "512",
     "-n_layer_phase", "2", "-n_lut", "4", "-lr_lut", "1e-2", "-s2_penalty", "0.5",
     "-pretrain_hf", "5", "-presolveH", "-n_train", "6", "-output_freq", "5",
     "-n_unq_samps_max", "100000", "-s", "7"],
    ["-m", "data/N2", "-comb_amp_phase", "-input_encoding", "integer", "-n_lut", "3",
     "-profile", "-no_amp_sym", "-phase_sym", "-no_restrictedH", "-n_samps", "2.5e4"],
    ["--molecule", "x/y/Li2O/", "-full_mask_psi", "-n_samps", "3e9", "-qo", "0",
     "-ws_solve_h", "100", "-ws_loss", "overlap", "-ws_full_basis", "-sample_dP", "1e-6",
     "-c", "-r", "-l", "prev", "-loadH", "-overwriteH", "-n_excitations_max", "4"],
    ["-no_mask_psi", "-n_samps", "999", "-weight_by_psi", "-sample_beta", "0.5"],
]


def _signature(action):
    return (type(action).__name__, tuple(action.option_strings), action.dest, action.default,
            action.type, tuple(action.choices) if action.choices else None, action.nargs,
            action.const, action.required)


def test_parser_matches_jax_flag_for_flag():
    want = {a.dest: _signature(a) for a in cli_j.get_parser()._actions}
    got = {a.dest: _signature(a) for a in cli_t.get_parser()._actions}
    assert got == want
    assert [a.dest for a in cli_t.get_parser()._actions] == \
        [a.dest for a in cli_j.get_parser()._actions]


@pytest.mark.parametrize("argv", ARGVS, ids=lambda a: " ".join(a)[:40] or "defaults")
def test_same_argv_parses_the_same(argv):
    a_j = cli_j.get_parser().parse_args(argv)
    a_t = cli_t.get_parser().parse_args(argv)
    assert vars(a_t) == vars(a_j)
    assert cli_t._exp_name(a_t) == cli_j._exp_name(a_j)


def test_save_log_writes_the_jax_lines(tmp_path):
    log = {"E": [(1, -1.1), (5, None)], "E_LOC": [(1, -1.05), (2, -1.125)],
           "E_LOC_VAR": [(1, 0.25), (2, 1e-9)], "N_UNIQUE_SAMP": [(1, 4), (2, 3)],
           "TIME": []}
    p_j = profiling_j.save_log(log, str(tmp_path / "log_j"))
    p_t = profiling_t.save_log(log, str(tmp_path / "log_t.ext"))
    assert os.path.basename(p_t) == "log_t.jsonl"
    with open(p_j) as f_j, open(p_t) as f_t:
        assert f_t.read() == f_j.read()
    assert [k.value for k in profiling_t.LogKey] == [k.value for k in profiling_j.LogKey]


@pytest.fixture(scope="module")
def h2_npz(tmp_path_factory):
    path = tmp_path_factory.mktemp("mol") / "H2.npz"
    save_molecule_npz(molecule_from_fields(fields("H2"), load_hamiltonian=False), str(path))
    return str(path)


def test_hamiltonian_fname_replaces_the_jordan_wigner_terms(h2_npz, tmp_path, monkeypatch):
    """-hf / --hamiltonian_fname: the pickled qubit Hamiltonian is the
    molecule's, in place of the transform of its integrals."""
    import naqs_tpu_torch as nt
    from test_torch_host_layer import _FakeQubitOperator, _pickle_with_openfermion_name

    jw = nt.load_molecule(h2_npz).qubit_hamiltonian
    scaled = {k: 0.5 * v for k, v in jw.items()}
    path = str(tmp_path / "h.pkl")
    _pickle_with_openfermion_name(_FakeQubitOperator(scaled), path, monkeypatch)
    mol = nt.load_molecule(h2_npz, hamiltonian_fname=path)
    assert mol.qubit_hamiltonian == scaled != jw
    assert mol.n_qubits == 4 and mol.fci_energy == nt.load_molecule(h2_npz).fci_energy


def test_cli_trains_h2_to_chemical_accuracy_on_the_cpu(h2_npz, tmp_path):
    """A subprocess of `python -m naqs_tpu_torch.cli -platform cpu`, with one
    LUT shell: chemical accuracy of the exact energy and the run's files."""
    out = tmp_path / "run"
    env = dict(os.environ, PYTHONPATH=REPO, OMP_NUM_THREADS="2")
    proc = subprocess.run(
        [sys.executable, "-m", "naqs_tpu_torch.cli", "-platform", "cpu", "-m", h2_npz,
         "-n_lut", "1", "-n_train", "200", "-lr", "1e-2", "-n_hid", "16", "-n_samps", "1e5",
         "-n_unq_samps_min", "2", "-n_unq_samps_max", "16", "-pretrain_hf", "5",
         "-output_freq", "100", "-presolveH", "-s", "1", "-o", str(out)],
        cwd=tmp_path, env=env, capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stdout[-2000:] + proc.stderr[-2000:]
    with open(out / "summary.json") as f:
        summary = json.load(f)
    assert summary["vmc_chem_acc"] is True, summary
    assert summary["vmc_estimator"] == "exact_psi_H_psi"
    assert summary["e_exact_final"] > summary["fci_energy"] - 1e-6
    for name in ("args.json", "log.jsonl", "checkpoint.pt"):
        assert (out / name).exists(), name
    with open(out / "log.jsonl") as f:
        lines = [json.loads(x) for x in f]
    assert sum(x["key"] == "E_LOC" for x in lines) == 200
    assert json.load(open(out / "args.json"))["resolved_seed"] == 1


def test_cli_profiles_and_resumes_in_process(h2_npz, tmp_path, monkeypatch):
    """Run B's model flags at a small size: -profile writes a Chrome trace,
    -c resumes from checkpoint.pt for the steps left."""
    monkeypatch.chdir(tmp_path)
    argv = ["-platform", "cpu", "-m", h2_npz, "-comb_amp_phase", "-input_encoding", "integer",
            "-n_lut", "1", "-n_hid", "8", "-n_samps", "1e4", "-n_unq_samps_min", "2",
            "-n_unq_samps_max", "16", "-output_freq", "5", "-s", "3", "-o", "out"]
    cli_t.run(argv + ["-n_train", "3", "-profile"])
    assert os.path.exists("out/profile/trace.json")
    res = cli_t.run(argv + ["-n_train", "5", "-c"])
    lines = [json.loads(x) for x in open("out/log.jsonl")]
    assert [x["step"] for x in lines if x["key"] == "E_LOC"] == [1, 2, 3, 4, 5]
    assert res["run_0"]["seed"] == 3


@pytest.mark.parametrize("argv,item", [
    (["-devices", "2"], "Queue A item 2")], ids=lambda v: v[0] if isinstance(v, list) else "")
def test_unported_flags_exit_with_their_roadmap_item(argv, item, capsys):
    with pytest.raises(SystemExit) as e:
        cli_t.run(["-platform", "cpu"] + argv)
    assert e.value.code != 0
    err = capsys.readouterr().err
    assert "ROADMAP.md" in err and item in err and argv[0] in err


def test_no_card_and_no_platform_fails(h2_npz, tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        cli_t.run(["-m", h2_npz, "-n_train", "1", "-o", "out"])
    assert not os.path.exists("out")
