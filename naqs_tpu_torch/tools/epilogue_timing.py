"""Time tables_epilogue's two mappings across row counts, and the amp trunk's
last product's backward on a gradient in each layout.

    python -m naqs_tpu_torch.tools.epilogue_timing

On the card, at H2O 6-31G's full width (26 qubits, 13 shells, amp 64, phase
512x512, random weights from seed 0), for each row count in ROWS (rows of
(5, 5) sector states drawn from seed 0; an SR update's live rows are about
27,000, the Adam step's batch 100,000): the nets' raw outputs as `log_psi`
makes them (shell-major) and the same values row-major. Each mode of
`tables_epilogue` (forward, vjp, jvp) is held in turns
(`utils/cuda_timing.py`: 5 repeats of 50 launches) through its row tiles and
through one thread a (row, shell) (the wrapper's ROW_TILES_MIN set to 0, and
past the row count), on both layouts, beside the one PyTorch call that does
part of its work (`torch.log_softmax` and its backward on the masked logits
(rows, S, 4)); every mapping and layout must give the bits of the row tiles
on the nets' layout. Then the amp trunk's last product
(`einsum("...si,sio->...so")` plus its bias) and its backward through
autograd, on a gradient shell-major (as the vjp writes it) and row-major (as
the first design of the vjp wrote it): held in turns, and one profiled
backward of each with its device kernels. Prints the card's name and power
limit first and one JSON line last.
"""

from __future__ import annotations

import json
import subprocess
import sys

import numpy as np
import torch

HBM_BYTES_PER_S = 3.35e12
ROWS = (16_000, 27_000, 40_000, 55_000, 70_000, 100_000)
REPEATS, LAUNCHES = 5, 50


def batch(dev, n, rng):
    """n packed states of 13 shells with 5 up- and 5 down-spins each."""
    out = np.zeros(n, np.int64)
    for spin in (0, 1):
        pos = np.argsort(rng.random((n, 13)), axis=1)[:, :5]
        for i in range(5):
            out |= np.int64(1) << (2 * pos[:, i] + spin)
    return torch.as_tensor(out, device=dev)


def case(model, cfg, dev, n):
    """(args on the nets' layout, args row-major, cotangents, (tangents laid out
    as each args' primals), (the masked logits (rows, S, 4), their log-softmax
    and a gradient of it for the library calls), the trunk's last input)."""
    from naqs_tpu_torch.models import nade
    from naqs_tpu_torch.ops import nade_glue as g

    states = batch(dev, n, np.random.default_rng(0))
    x, x2, code = g.state_features(cfg, states)
    taps = {}
    with torch.no_grad():
        raw, raw_phase = nade._raw(model, x, x2, taps=taps)
    raw_c = raw.contiguous()
    ph_c = None if raw_phase is None else raw_phase.contiguous()
    gen = torch.Generator(device=dev).manual_seed(1)
    cot = [torch.randn(n, generator=gen, device=dev, dtype=raw.dtype) for _ in range(2)]
    tan_c = [None if t is None else torch.randn(t.shape, generator=gen, device=dev,
                                                dtype=raw.dtype) for t in (raw_c, ph_c)]
    tan = [None if t is None else torch.empty_like(p).copy_(t)
           for t, p in zip(tan_c, (raw, raw_phase))]
    f = g.unpack_code(code)
    logits = g.symmetrize_amp(raw[..., :cfg.n_amp_out], f["order3"])
    z = torch.where(g._applied_mask(cfg, f), 2.0 * logits, g.BIG_NEG).contiguous()
    lsm = torch.log_softmax(z, dim=-1)
    grad = torch.randn(lsm.shape, generator=gen, device=dev, dtype=lsm.dtype)
    return ((raw, raw_phase, code), (raw_c, ph_c, code), cot, (tan, tan_c), (z, lsm, grad),
            taps["amp"][-1])


def bound_ms(args, outs) -> float:
    n = sum(t.numel() * t.element_size() for t in (*args, *outs) if t is not None)
    return n / HBM_BYTES_PER_S * 1e3


def through(row_tiles_min, fn):
    """fn with the wrappers' ROW_TILES_MIN set to row_tiles_min."""
    from naqs_tpu_torch.ops import nade_glue as g

    def call():
        saved, g.ROW_TILES_MIN = g.ROW_TILES_MIN, row_tiles_min
        try:
            return fn()
        finally:
            g.ROW_TILES_MIN = saved

    return call


def last_product(model, h, layouts):
    """{layout: a function running the amp trunk's last product on h and its
    backward (the gradients of h, w and b) from a gradient in that layout}."""
    w, b = model.amp.w[-1], model.amp.b[-1]
    h = h.detach().requires_grad_()
    y = torch.einsum("...si,sio->...so", h, w) + b
    g_sm = torch.randn(y.shape[1], y.shape[0], y.shape[2], device=y.device,
                       generator=torch.Generator(device=y.device).manual_seed(3)).transpose(0, 1)
    grads = {"shell-major": g_sm, "row-major": g_sm.contiguous()}

    def run(gr):
        out = torch.einsum("...si,sio->...so", h, w) + b
        return torch.autograd.grad(out, (h, w, b), gr)

    return {k: (lambda gr=grads[k]: run(gr)) for k in layouts}


def kernels_of(fn):
    """{device kernel name: (launches, device ms)} of one fn() under
    torch.profiler, after one untraced call."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    return {e.key[:100]: (e.count, e.self_device_time_total / 1e3)
            for e in prof.key_averages() if e.device_type == DeviceType.CUDA}


def main(argv) -> int:
    if not torch.cuda.is_available():
        print("epilogue_timing: no CUDA device available", file=sys.stderr)
        return 2
    from naqs_tpu_torch.models import nade
    from naqs_tpu_torch.ops import nade_glue as g
    from naqs_tpu_torch.utils.cuda_timing import time_in_turns

    dev = torch.device("cuda")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True).stdout.strip().splitlines()[0]
    print(f"[card] {smi}", flush=True)
    cfg = nade.NAQSConfig(n_qubits=26, sectors=((5, 5),), amp_hidden=(64,),
                          phase_hidden=(512, 512))
    model = nade.NADE(cfg, torch.Generator().manual_seed(0)).to(dev)
    result = {"card": smi, "epilogue": {}, "last_product": {}}
    for n in ROWS:
        args, args_c, cot, (tan, tan_c), (z, lsm, grad), h = case(model, cfg, dev, n)
        calls = {"forward": lambda a, t: g.tables_epilogue(cfg, *a),
                 "vjp": lambda a, t: g.tables_epilogue_vjp(cfg, *a, *cot),
                 "jvp": lambda a, t: g.tables_epilogue_jvp(cfg, *a, *t)}
        library = {"forward": lambda: torch.log_softmax(z, dim=-1),
                   "vjp": lambda: torch._log_softmax_backward_data(grad, lsm, -1, lsm.dtype)}
        for mode, call in calls.items():
            name = f"{mode}, {n} rows"
            fns = {}
            for tag, least in (("row tiles", 0), ("a thread a (row, shell)", n + 1)):
                fns[f"{tag}, the nets' layout"] = through(least, lambda c=call: c(args, tan))
                fns[f"{tag}, row-major"] = through(least, lambda c=call: c(args_c, tan_c))
            want = fns["row tiles, the nets' layout"]()
            same = {label: g.same_bits(tuple(fn()), tuple(want)) for label, fn in fns.items()}
            print(f"[case] {name}: bitwise the row tiles' on the nets' layout: {same}",
                  flush=True)
            if not all(same.values()):
                raise SystemExit(f"epilogue_timing: {name} differs between mappings or layouts")
            if mode in library:
                fns["library call"] = library[mode]
            extra = (*cot,) if mode == "vjp" else (*tan,) if mode == "jvp" else ()
            bound = bound_ms((*args, *extra), want)
            times = time_in_turns(fns, REPEATS, LAUNCHES)
            for label, (med, spread, _) in times.items():
                print(f"[time] {name} | {label}: {med:.4f} ms (spread {spread[0]:.4f}-"
                      f"{spread[1]:.4f}), {bound / med:.0%} of its bound {bound:.5f} ms",
                      flush=True)
            result["epilogue"][name] = {"bound_ms": bound,
                                        "ms": {k: v[0] for k, v in times.items()},
                                        "spread": {k: v[1] for k, v in times.items()}}
        back = last_product(model, h, ("shell-major", "row-major"))
        times = time_in_turns(back, REPEATS, LAUNCHES)
        kernels = {k: kernels_of(fn) for k, fn in back.items()}
        for label, (med, spread, _) in times.items():
            print(f"[back] {n} rows, the last product and its backward on a {label} gradient: "
                  f"{med:.4f} ms (spread {spread[0]:.4f}-{spread[1]:.4f}); kernels "
                  f"{kernels[label]}", flush=True)
        result["last_product"][n] = {"ms": {k: v[0] for k, v in times.items()},
                                     "kernels": kernels}
        del args, args_c, cot, tan, tan_c, z, lsm, grad, h, back
        torch.cuda.empty_cache()
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
