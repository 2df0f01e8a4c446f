"""What the ranks of the data-parallel tests run (the other
`tests/test_torch_parallel_*.py`); it holds no tests.

Each function runs in one rank process that `naqs_tpu_torch.parallel.launch.spawn`
started, in a gloo group on the CPU; it takes numpy inputs and returns numpy
results. This module imports neither JAX nor `naqs_tpu` (checked by
`tests/test_torch_host.py`), so a rank never loads either.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

import naqs_tpu_torch as nt
from naqs_tpu_torch.models.nade import NADE
from naqs_tpu_torch.ops import dense_engine as de
from naqs_tpu_torch.ops.local_energy import DeviceTerms, local_energy
from naqs_tpu_torch.parallel import comm
from naqs_tpu_torch.parallel import step as pstep
from naqs_tpu_torch.sampler import SampleBatch
from naqs_tpu_torch.trainer import TrainConfig, UpdateWindow, sector_table


def _batch(b) -> SampleBatch:
    states, counts, n_unique, overflow = b
    return SampleBatch(torch.as_tensor(states), torch.as_tensor(counts),
                       torch.tensor(int(n_unique)), torch.tensor(bool(overflow)))


def engine_terms(hilbert, terms, engine: str) -> DeviceTerms:
    """The port's DeviceTerms of one engine: "dense", "fact", "rank", "sort",
    or "xl" (the staircase engine, forced past the grid caps as the JAX
    package's tests force it)."""
    if engine == "xl":
        caps = de.DENSE_SIZE_MAX, de.FACT_SIZE_MAX
        de.DENSE_SIZE_MAX = de.FACT_SIZE_MAX = 1
        try:
            dt = DeviceTerms.from_terms(terms, hilbert=hilbert, device="cpu")
        finally:
            de.DENSE_SIZE_MAX, de.FACT_SIZE_MAX = caps
        assert type(dt.dense).__name__ == "FactorTermsXL"
        return dt
    dt = DeviceTerms.from_terms(terms, hilbert=hilbert, device="cpu")
    if engine == "fact":
        return dataclasses.replace(dt, dense=de.FactorTerms.build(terms, hilbert, device="cpu"))
    if engine == "rank":
        return dataclasses.replace(dt, dense=None)
    if engine == "sort":
        return dataclasses.replace(dt, dense=None, rank_spec=None)
    assert type(dt.dense).__name__ == "DenseTerms"
    return dt


def sharded_eloc(spaces: dict, shards: list) -> dict:
    """Per engine, E_loc of this rank's rows against the merged buffer of
    every rank's rows (`step.merge_shards`). spaces: engine -> (Hilbert,
    PauliTerms); shards: per rank (states, log_amp, phase, n_valid). Returns
    {engine: (e_re, e_im)} and the merged buffer's states, n_valid, n_unique."""
    torch.set_num_threads(1)
    states, la, ph, n = (torch.as_tensor(a) for a in shards[comm.rank()])
    live = torch.arange(states.shape[0]) < n
    merged = pstep.merge_shards(states, la, ph, live,
                                torch.ones(states.shape[0], dtype=torch.float64))
    out = {}
    for engine, (hilbert, terms) in spaces.items():
        dt = engine_terms(hilbert, terms, engine)
        e_re, e_im = local_energy(dt, merged.states, merged.la, merged.ph, merged.n_valid,
                                  queries=(states, la, ph))
        out[engine] = (e_re.numpy(), e_im.numpy())
    out["merged"] = (merged.states.numpy(), merged.la.numpy(), int(merged.n_valid),
                     int(merged.n_unique))
    return out


def gather_bits(rows: list) -> tuple:
    """`comm.all_gather_rows` of this rank's arrays (one per dtype)."""
    mine = [torch.as_tensor(a) for a in rows[comm.rank()]]
    return tuple(t.numpy() for t in comm.all_gather_rows(*mine))


def _model(cfg_kw: dict, params: dict):
    model = NADE(nt.NAQSConfig(**cfg_kw))
    model.load_state_dict({k: torch.as_tensor(v) for k, v in params.items()})
    return model


def _named(model) -> dict:
    return {k: v.detach().clone() for k, v in model.named_parameters()}


def _adam_state(model, opt) -> dict:
    """{name: (step, exp_avg, exp_avg_sq)} of the parameters Adam has state for."""
    return {k: tuple(opt.state[p][x].clone() for x in ("step", "exp_avg", "exp_avg_sq"))
            for k, p in model.named_parameters() if opt.state.get(p)}


def sharded_adam(cfg_kw, params, hilbert, terms, cases: list) -> list:
    """Per case, data-parallel Adam updates (`sharded_adam_update`) from the
    given parameters and a fresh optimizer, one a step of `steps` (each a
    per-rank list of batches). Returns per case and step: the summed
    gradients as Adam received them, the parameters after, the metrics
    (device scalars read back as numpy), the clip ring, the Adam state and the
    scheduler's count."""
    torch.set_num_threads(1)
    r = comm.rank()
    out = []
    for case in cases:
        model = _model(cfg_kw, params)
        dt = engine_terms(hilbert, terms, "dense")
        tc = TrainConfig(**case["tc"])
        opt, sched = tc.make_optimizer(model.parameters())
        clip = tc.make_clip()
        if case.get("ring") is not None:
            clip.load_state_dict(case["ring"])
        table = (sector_table(hilbert.basis, case["chunk"], "cpu", comm.world())
                 if case.get("exact") else None)
        steps = []
        for batches in case["steps"]:
            window = UpdateWindow(model, opt, sched, 1, clip)
            grads = {}
            apply = window.apply

            def capture(ps, *rest, apply=apply, grads=grads):
                grads.update({k: p.grad.clone() for k, p in model.named_parameters()})
                apply(ps, *rest)

            window.apply = capture
            m = pstep.sharded_adam_update(model, window, dt, _batch(batches[r]),
                                          case.get("reweight", False), table,
                                          case.get("chunk", 65536))
            window.settle(0 if bool(m["overflow"]) else 1)
            steps.append(dict(
                grads={k: v.numpy() for k, v in grads.items()},
                params={k: v.numpy() for k, v in _named(model).items()},
                metrics={k: v.detach().numpy() for k, v in m.items()},
                ring=None if clip is None else (clip.norms.numpy().copy(), int(clip.count)),
                adam={k: tuple(t.numpy() for t in v) for k, v in _adam_state(model, opt).items()},
                sched=sched.last_epoch, lr=opt.param_groups[0]["lr"]))
        out.append(steps)
    return out


def sharded_sr(cfg_kw, params, hilbert, terms, cases: list) -> list:
    """Per case, one data-parallel SR update (`sharded_sr_update`) on this
    rank's batch. Returns the parameters after and the metrics."""
    torch.set_num_threads(1)
    r = comm.rank()
    out = []
    for case in cases:
        model = _model({**cfg_kw, **case.get("cfg", {})}, case.get("params", params))
        dt = engine_terms(hilbert, terms, "dense")
        m = pstep.sharded_sr_update(model, dt, _batch(case["batches"][r]), case["lr"],
                                    case["damping"], case["cg_iters"],
                                    case.get("reweight", False), case.get("kl_clip"),
                                    case.get("fisher_mix", 0.0))
        out.append(dict(params={k: v.numpy() for k, v in _named(model).items()},
                        metrics={k: v.detach().numpy() for k, v in m.items()}))
    return out


def sharded_kfac(cfg_kw, params, hilbert, terms, batches: list, hyper: dict) -> list:
    """Data-parallel K-FAC updates (`sharded_kfac_update`) from fresh
    factors, one a step of `batches`. Returns per step the parameters, the
    factors and the metrics."""
    from naqs_tpu_torch.kfac import kfac_init
    from naqs_tpu_torch.trainer import _leaves

    torch.set_num_threads(1)
    r = comm.rank()
    model = _model(cfg_kw, params)
    dt = engine_terms(hilbert, terms, "dense")
    kstate = kfac_init(model)
    out = []
    for step in batches:
        kstate, m = pstep.sharded_kfac_update(model, kstate, dt, _batch(step[r]), **hyper)
        out.append(dict(params={k: v.numpy() for k, v in _named(model).items()},
                        kstate={k: [{x: f[x].numpy() for x in f} for f in v]
                                for k, v in kstate.items() if k != "step"},
                        kstep=int(kstate["step"]), n_leaves=len(_leaves(kstate)),
                        metrics={k: v.detach().numpy() for k, v in m.items()}))
    return out


def trainer_steps(hilbert, terms, cfg_kw: dict, cases: dict, steps: int, out_dir: str) -> dict:
    """Per case (TrainConfig fields), a VMCTrainer with n_devices = the
    group's size takes 2 epochs of pre_train_hf, then `steps` step()s on the
    CPU; then save() and save_log() into out_dir/<case>/rank<r>. Returns per case: the parameters, Adam's
    state, the clip ring and K-FAC's factors as bytes, the log, n_samples,
    the overflow the controller noted, the counter's size and the files
    written."""
    import os

    from naqs_tpu_torch.trainer import VMCTrainer, _leaves

    torch.set_num_threads(1)
    out = {}
    for name, tc_kw in cases.items():
        tr = VMCTrainer(nt.NAQSConfig(**cfg_kw), terms, hilbert, TrainConfig(**tc_kw),
                        device="cpu", n_devices=comm.world(),
                        save_loc=os.path.join(out_dir, name, f"rank{comm.rank()}"))
        tr.pre_train_hf(2)   # each rank's own Adam, then rank 0's state on every rank
        rows = [tr.step() for _ in range(steps)]
        tr.save()
        tr.save_log()
        state = [t for st in tr.optimizer.state.values() for t in st.values()]
        if tr.clip is not None:
            state += [tr.clip.norms, tr.clip.count]
        if tr.kfac_state is not None:
            state += _leaves(tr.kfac_state)
        out[name] = dict(
            params={k: v.detach().numpy().tobytes() for k, v in tr.model.named_parameters()},
            state=[torch.as_tensor(t).numpy().tobytes() for t in state],
            rows=rows, log=tr.log, n_samples=tr.n_samples, ovf_n=tr._ovf_n,
            n_steps=tr.n_steps, counter=len(tr.sampled_counter),
            files=sorted(os.listdir(tr.save_loc)) if os.path.isdir(tr.save_loc) else [])
    return out


def trainer_resume(hilbert, terms, cfg_kw: dict, tc_kw: dict, steps: int, out_dir: str) -> dict:
    """A VMCTrainer with n_devices = the group's size takes `steps` step()s,
    saves into out_dir (every rank calls save; rank 0 writes) and takes
    `steps` more; a second trainer, of another seed, loads the checkpoint
    and takes the same `steps`. Returns each rank's generator state at the
    save and after the load, the states of one batch drawn from a copy of
    the resumed generator, and both runs' steps after the save (the rows
    but for wall times, and the parameters as bytes)."""
    from naqs_tpu_torch.sampler import sample
    from naqs_tpu_torch.trainer import VMCTrainer

    torch.set_num_threads(1)
    cfg = nt.NAQSConfig(**cfg_kw)
    tr = VMCTrainer(cfg, terms, hilbert, TrainConfig(**tc_kw), device="cpu",
                    n_devices=comm.world(), save_loc=out_dir)
    for _ in range(steps):
        tr.step()
    tr.save()
    saved = tr.gen.get_state().numpy().tobytes()
    timeless = lambda rows: [{k: v for k, v in r.items() if k != "time"} for r in rows]
    params = lambda t: {k: v.detach().numpy().tobytes() for k, v in t.model.named_parameters()}
    on = timeless([tr.step() for _ in range(steps)])
    out = dict(saved=saved, on=on, on_params=params(tr))
    tr2 = VMCTrainer(cfg, terms, hilbert, TrainConfig(**{**tc_kw, "seed": tc_kw["seed"] + 7}),
                     device="cpu", n_devices=comm.world(), save_loc=out_dir)
    tr2.load()
    out["loaded"] = tr2.gen.get_state().numpy().tobytes()
    copy = torch.Generator().manual_seed(0)
    copy.set_state(tr2.gen.get_state())
    out["draw"] = sample(tr2.model, copy, 200.0, 64).states.numpy()
    out["resumed"] = timeless([tr2.step() for _ in range(steps)])
    out["resumed_params"] = params(tr2)
    return out
