"""Step times of kernels B (``csrc/lstm.cu``) and C (``csrc/lstm_bwd.cu``)
on one GPU, at the main path's shapes.

    python -m styler_tpu_torch.tools.lstm_steps [--widths HP ...] [--baseline DIR] [--out FILE]

Shapes: one BiLSTM layer of the audio encoder, 8 recurrences (hidden
sizes 80, 80 and six of 64, padded to Hp = 80), T = 256 steps; kernel B's
serving form at B = 1, its training form and kernel C at B = 16. Inputs
are seeded (gates normal, w_hh uniform in +-1/sqrt(H), dh normal); the
kernels' times do not depend on the values.

Per kernel and form: CUDA-event time over 20 launches after a warm-up,
ns per step (time / T), the launch plan, the largest error against the
plain version, and the SM clock, power draw and power limit sampled by
nvidia-smi right after the timing. Then kernel C's split: CUDA-event
times of its walk alone and of its dW product alone.

Then the sweep: every plan instance the wrappers have (``registers``,
``shared``, ``global`` weights) forced at Hp = 80 for each kernel and
form, and every dW split count in (1, 2, 4, 8, 16) (given to the timing
helper), each timed and checked against the plain version. Then ns per
step of B (both forms), of C's walk and C's whole launch against the
width, all 8 recurrences at each Hp of ``--widths``: the plan's own
instance where the register instances take the width, and above that
every instance that takes it, side by side. This splits a step into the
part that grows with the product and the part that does not.
``--baseline DIR`` then times the whole launches of another checkout's
kernels at the same widths (for example the parent commit, unpacked with
``git archive``), in a child process that runs this file against DIR's
package. Last, the empty-step probe: T steps of one barrier and one
float4 broadcast from shared memory and no arithmetic, at the walk's 320
threads, the per-step latency floor of any one-CTA design.

One JSON line per measurement; ``--out`` also writes them to a file.
Fails without a CUDA device or when a check fails.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys

import numpy as np
import torch

from styler_tpu_torch.core.device import resolve_device
# names that every checkout's ops/lstm.py has had since kernel C was
# ported, so that --baseline can run this file against an older one; the
# rest are imported where they are used
from styler_tpu_torch.ops.lstm import (
    lstm_backward,
    lstm_backward_plain,
    lstm_recurrence,
    lstm_recurrence_plain,
    pack_gates,
    pack_w_hh,
)

HIDDENS = (80, 80, 64, 64, 64, 64, 64, 64)
WIDTHS = (8, 16, 32, 48, 64, 80, 96, 104, 112)
T = 256
ITERS = 20
# the card tolerances of tests/test_torch_cuda.py: B serving 2e-5, B
# training 5e-5 x max(1, scale), C 1e-4 x scale
TOL = {"serving": 2e-5, "training": 5e-5, "backward": 1e-4}


def smi(query: str) -> str:
    return subprocess.run(["nvidia-smi", f"--query-gpu={query}", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]


def time_ms(fn, iters=ITERS) -> float:
    fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def problem(B: int, dev, seed: int = 0, hiddens=HIDDENS):
    """Packed gates, w_t and dh for one layer of ``hiddens`` at batch B."""
    rng = np.random.default_rng(seed)
    gates, w_hh = [], []
    for H in hiddens:
        gates.append(torch.from_numpy(rng.standard_normal((B, T, 4 * H)).astype(np.float32)))
        bound = 1.0 / np.sqrt(H)
        w_hh.append(torch.from_numpy(rng.uniform(-bound, bound, (4 * H, H)).astype(np.float32)))
    hp = max(hiddens)
    dh = torch.zeros(len(hiddens), B, T, hp)
    for s, H in enumerate(hiddens):
        dh[s, ..., :H] = torch.from_numpy(rng.standard_normal((B, T, H)).astype(np.float32))
    return pack_gates(gates, hp).to(dev), pack_w_hh(w_hh, hp).to(dev), dh.to(dev)


def rel_err(got, want) -> float:
    return (got - want).abs().max().item() / max(want.abs().max().item(), 1.0)


def check_forward(g, w, save: bool) -> float:
    with torch.no_grad():
        got = lstm_recurrence(g, w, save=save)
        torch.cuda.synchronize()
        want = lstm_recurrence_plain(g, w, save=save)
    if save:
        return max(rel_err(a, b) for a, b in zip(got, want))
    return (got - want).abs().max().item()


def check_backward(dh, acts, c, h, w) -> float:
    dg, dw = lstm_backward(dh, acts, c, h, w)
    torch.cuda.synchronize()
    dg_p, dw_p = lstm_backward_plain(dh, acts, c, h, w)
    return max(rel_err(dg, dg_p), rel_err(dw, dw_p))


def walk_dw_split(dh, acts, c, h, w, dw_splits=None) -> dict:
    """CUDA-event ms per launch of kernel C's walk alone and of its dW
    product alone (``ops/lstm.py:lstm_backward_part``, the batch rows
    split in ``dw_splits`` groups or as the plan says), over ITERS each."""
    from styler_tpu_torch.ops.lstm import lstm_backward_part

    dg, dw = lstm_backward(dh, acts, c, h, w)
    return {f"{part}_ms": time_ms(lambda: lstm_backward_part(part, dh, acts, c, h, w, dg, dw,
                                                             dw_splits=dw_splits))
            for part in ("walk", "dw")}


def check_split(dh, acts, c, h, w, dw_splits: int) -> float:
    """Error of dW with its batch rows split in ``dw_splits`` groups
    against the plain version, relative to max(1, scale)."""
    from styler_tpu_torch.ops.lstm import lstm_backward_part

    dg, dw = lstm_backward(dh, acts, c, h, w)
    lstm_backward_part("dw", dh, acts, c, h, w, dg, dw, dw_splits=dw_splits)
    torch.cuda.synchronize()
    return rel_err(dw, lstm_backward_plain(dh, acts, c, h, w)[1])


def width_sweep(dev, widths, emit, every_instance: bool = True) -> None:
    """ns per step of B's two forms and of C's walk, and C's whole and dW
    times, with all 8 recurrences of the launch at each Hp of ``widths``:
    the step's fixed part (nonlinearities, shuffles, barrier) and the part
    that grows with the product. ``every_instance``: above the register
    instances' widths, every instance that takes the width, forced;
    otherwise the plan's own instance and whole launches only (what any
    checkout's wrappers offer)."""
    if every_instance:
        from styler_tpu_torch.ops.lstm import (
            INSTANCES, REGISTER_WIDTH_MAX, force_lstm_plan, lstm_plan)
    for hp in widths:
        g1, w, _ = problem(1, dev, hiddens=(hp,) * len(HIDDENS))
        g16, _, dh = problem(16, dev, hiddens=(hp,) * len(HIDDENS))
        with torch.no_grad():
            h, c, acts = lstm_recurrence_plain(g16, w, save=True)
        runs = [None]
        if every_instance:
            runs = [i for i in INSTANCES if hp > REGISTER_WIDTH_MAX or i == "registers"]
        for inst in runs:
            line = {"width_sweep": hp}
            try:
                if inst is not None:
                    force_lstm_plan(instance=inst)
                    lstm_plan(hp)  # raises where the instance does not take hp
                    line["instance"] = inst
                with torch.no_grad():
                    serving_ms = time_ms(lambda: lstm_recurrence(g1, w))
                    training_ms = time_ms(lambda: lstm_recurrence(g16, w, save=True))
                line.update(serving_ns_per_step=serving_ms * 1e6 / T,
                            training_ns_per_step=training_ms * 1e6 / T,
                            backward_ms=time_ms(lambda: lstm_backward(dh, acts, c, h, w)))
                if every_instance:
                    split = walk_dw_split(dh, acts, c, h, w)
                    line.update(walk_ns_per_step=split["walk_ms"] * 1e6 / T,
                                dw_ms=split["dw_ms"])
            except ValueError as e:  # an instance or checkout that does not take hp
                if inst is not None:
                    continue
                line["error"] = str(e)
            finally:
                if inst is not None:
                    force_lstm_plan()
            emit(**line)


def baseline(directory: str, widths, emit) -> bool:
    """Runs ``width_sweep`` with whole launches in a child process whose
    ``styler_tpu_torch`` is the one in ``directory`` (its kernels built
    from its own sources) and emits its lines tagged with the directory.
    Returns whether the child succeeded."""
    root = os.path.abspath(directory)
    proc = subprocess.run(
        [sys.executable, os.path.abspath(__file__), "--whole-launches",
         "--widths", *map(str, widths)],
        cwd=root, env={**os.environ, "PYTHONPATH": root}, capture_output=True, text=True,
    )
    for text in proc.stdout.splitlines():
        if text.startswith("{"):
            emit(**{**json.loads(text), "baseline": directory})
    if proc.returncode:
        emit(baseline=directory, error=proc.stderr[-4000:])
    return proc.returncode == 0


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--out", default=None, help="also write the JSON lines here")
    ap.add_argument("--widths", type=int, nargs="+", default=list(WIDTHS),
                    help="the Hp of the width sweep")
    ap.add_argument("--baseline", default=None, metavar="DIR",
                    help="also time another checkout's kernels at --widths")
    ap.add_argument("--whole-launches", action="store_true",
                    help="only the width sweep, of whole launches on the plan's own "
                         "instances (what --baseline runs in the other checkout)")
    args = ap.parse_args(argv)
    dev = resolve_device(None)
    card = smi("name,power.limit")
    lines = []
    ok = True

    def emit(**kw):
        lines.append(json.dumps({**kw, "card": card}))
        print(lines[-1], flush=True)

    if args.whole_launches:
        width_sweep(dev, args.widths, emit, every_instance=False)
        return 0

    from styler_tpu_torch.ops.lstm import (
        INSTANCES, force_lstm_plan, lstm_launch_plan, lstm_plan, lstm_step_probe)

    g1, w, _ = problem(1, dev)
    g16, _, dh = problem(16, dev)
    with torch.no_grad():
        h, c, acts = lstm_recurrence_plain(g16, w, save=True)
    runs = {
        "serving": (lambda: lstm_recurrence(g1, w), lambda: check_forward(g1, w, False), 1),
        "training": (lambda: lstm_recurrence(g16, w, save=True),
                     lambda: check_forward(g16, w, True), 16),
        "backward": (lambda: lstm_backward(dh, acts, c, h, w),
                     lambda: check_backward(dh, acts, c, h, w), 16),
    }

    def measure(form, **extra):
        nonlocal ok
        fn, chk, B = runs[form]
        err = chk()
        good = err <= TOL[form]
        ok &= good
        with torch.no_grad():
            ms = time_ms(fn)
        emit(kernel="lstm_backward" if form == "backward" else "lstm_recurrence", form=form,
             shape={"S": len(HIDDENS), "B": B, "T": T, "Hp": max(HIDDENS)}, ms=ms,
             ns_per_step=ms * 1e6 / T, max_err=err, tolerance=TOL[form], ok=good,
             clocks_sm_power_draw_limit=smi("clocks.sm,power.draw,power.limit"),
             plan=lstm_launch_plan(max(HIDDENS), len(HIDDENS), B), **extra)

    for form in runs:
        measure(form)
    emit(kernel="lstm_backward", split=walk_dw_split(dh, acts, c, h, w))
    for inst in INSTANCES:
        force_lstm_plan(instance=inst)
        try:
            for form in runs:
                measure(form, forced_instance=inst)
        finally:
            force_lstm_plan()
    for splits in (1, 2, 4, 8, 16):
        err = check_split(dh, acts, c, h, w, splits)
        good = err <= TOL["backward"]
        ok &= good
        emit(kernel="lstm_backward", part="dw", dw_splits=splits,
             plan_dw_splits=lstm_plan(max(HIDDENS), len(HIDDENS), 16, splits)["backward"]["dw_splits"],
             split=walk_dw_split(dh, acts, c, h, w, dw_splits=splits), max_err=err,
             tolerance=TOL["backward"], ok=good)
    width_sweep(dev, args.widths, emit)
    if args.baseline:
        ok &= baseline(args.baseline, args.widths, emit)
    threads = 4 * max(HIDDENS)
    probe_ms = time_ms(lambda: lstm_step_probe(T, threads, dev))
    emit(probe="empty step: one barrier and one float4 broadcast", threads=threads, T=T,
         ms=probe_ms, ns_per_step=probe_ms * 1e6 / T)
    emit(summary="lstm_steps", all_correct=ok)
    if args.out:
        with open(args.out, "w") as f:
            f.write("\n".join(lines) + "\n")
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
