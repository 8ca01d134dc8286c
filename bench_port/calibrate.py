"""The readings that the limits of ``correct`` are set from, on the card.

    python3 bench_port/calibrate.py --workload <cell> --seeds 1 2 ... \
        [--control-seeds 7 8 9] [--faults] [--late-faults] \
        [--order-seeds 4 5] [--seconds 2]

In one process: for each of ``--seeds`` the cell's own run (set-up, a
short window, the check) gives the program's numbers, the lower reading;
for each of ``--control-seeds`` the control, the plain reference computed
in TF32 (the card's TF32 on, and every conv's operands rounded to TF32) in
the program's place, gives the upper reading; with
``--faults`` (train cells) the faults a training step can have are read,
planted in the reference put in the program's place: half of each batch
left out (the mean taken over the rest) and a step's loss altered where it
is produced; a state left unchanged reads 1 on ``grad_gap`` and
``step_gap`` by their definition. With ``--late-faults`` (train cells,
on the ``--control-seeds``) the faults that leave the first call sound
and break the later ones are read on the check's later call, planted in
the reference put in the program's place: the call's noise drawn from
the first call's generator state again, and the first call's chunk
trained on again. With ``--order-seeds`` (train cells) the fp32
reference stands against itself with the conv algorithms that cuDNN's
search picks: what rounding alone reads, two sound sides that sum in
another order. One JSON line a reading. The benchmark's
own runs never run this.
"""

import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)


def _say(**kw):
    print(json.dumps(kw), flush=True)


def control_eval(params, model_cfg, seed, device):
    import torch

    from bench_port.harness import checks
    from bench_port.harness.weights import seeded_reference
    from bench_port.traffic.generator import Traffic

    x = torch.from_numpy(Traffic(params["traffic"], seed).next())
    ref = seeded_reference(model_cfg, seed, device,
                           params.get("weights"))
    terms, xhat = checks.reference_eval(ref, x, params["lambda"], device)
    checks.lower_precision(ref)
    low, low_xhat = checks.reference_eval(ref, x, params["lambda"], device,
                                          tf32=True)
    return checks.eval_numbers(low, low_xhat, terms, xhat)


def _train_reading(params, model_cfg, seed, device, tf32=False,
                   batch_slice=slice(None), other_order=False):
    """The fp32 reference's checked steps, and the same steps in TF32, on
    part of each batch, or (``other_order``) in fp32 with the conv
    algorithms cuDNN's own search picks, in the program's place."""
    import torch

    from bench_port.harness import checks
    from bench_port.harness.weights import seeded_reference
    from bench_port.traffic.generator import Traffic, stream_seed

    tp = params["traffic"]
    k = tp["steps_per_call"]
    traffic = Traffic(tp, seed)
    chunks = [traffic.next() for _ in range(-(-3 // k))]
    gen = torch.Generator(device=device)
    gen.manual_seed(stream_seed(seed, "noise", 64))
    state = gen.get_state()
    args = (params["learning_rate"], params["rate_weight"],
            params["lambda"], device)
    ref = seeded_reference(model_cfg, seed, device,
                           params.get("weights"))
    init = {n: p.detach().clone() for n, p in ref.named_parameters()}
    rows, m, p = checks.reference_train(ref, chunks, state, *args,
                                        moment_after=k)
    alt = seeded_reference(model_cfg, seed, device,
                           params.get("weights"))
    if tf32:
        checks.lower_precision(alt)
    searched = torch.backends.cudnn.benchmark
    torch.backends.cudnn.benchmark = other_order
    try:
        a_rows, a_m, a_p = checks.reference_train(
            alt, chunks, state, *args, tf32=tf32, batch_slice=batch_slice,
            moment_after=k)
    finally:
        torch.backends.cudnn.benchmark = searched
    return rows, m, p, init, a_rows, a_m, a_p


def _clone(end):
    return {n: tuple(x.detach().clone() if hasattr(x, "detach") else x
                     for x in v) for n, v in end.items() if n != "generator"}


def late_faults(params, model_cfg, seed, device):
    """{fault: numbers} of the check's later call: the reference goes on
    for one call of k steps from its own state after the first call, and
    the same call with a fault stands in for the program's."""
    import torch

    from bench_port.harness import checks
    from bench_port.harness.weights import seeded_reference
    from bench_port.traffic.generator import Traffic, stream_seed

    tp = params["traffic"]
    k = tp["steps_per_call"]
    traffic = Traffic(tp, seed)
    c1, c2 = traffic.next(), traffic.next()
    gen = torch.Generator(device=device)
    gen.manual_seed(stream_seed(seed, "noise", 64))
    g0 = gen.get_state()
    args = (params["learning_rate"], params["rate_weight"],
            params["lambda"], device)
    ref = seeded_reference(model_cfg, seed, device, params.get("weights"))
    end = {}
    checks.reference_train(ref, [c1], g0, *args, end=end)
    g1 = end["generator"]
    start = _clone(end)
    host = {n: tuple(x.cpu() if hasattr(x, "cpu") else x for x in v)
            for n, v in start.items()}
    sound = {}
    rows, _, _ = checks.reference_train(ref, [c2], g1, *args, start=start,
                                        end=sound)
    sound = _clone(sound)
    out = {}
    for fault, (state, chunk) in (("noise_not_advanced", (g0, c2)),
                                  ("input_not_refilled", (g1, c1))):
        bad = {}
        f_rows, _, _ = checks.reference_train(ref, [chunk], state, *args,
                                              start=start, end=bad)
        after = {n: tuple(x.cpu() if hasattr(x, "cpu") else x for x in v)
                 for n, v in bad.items() if n != "generator"}
        out[fault] = checks.late_numbers(f_rows, host, after, rows, sound,
                                         k)
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="*", default=[])
    ap.add_argument("--control-seeds", type=int, nargs="*", default=[])
    ap.add_argument("--faults", action="store_true")
    ap.add_argument("--late-faults", action="store_true")
    ap.add_argument("--order-seeds", type=int, nargs="*", default=[])
    ap.add_argument("--seconds", type=float, default=2.0)
    args = ap.parse_args(argv)

    import torch

    from bench_port.harness import checks, common
    from bench_port.run import run_cell

    if not torch.cuda.is_available():
        print("the readings are taken on a card", file=sys.stderr)
        return 2
    params = common.workload(args.workload)
    model_cfg = common.model_config(params["config"])
    train = params["entry"] == "train"
    for seed in args.seeds:
        t = time.perf_counter()
        result, _ = run_cell(args.workload, seed, args.seconds, False)
        _say(reading="program", seed=seed, correct=result["correct"],
             numbers=result["numbers"], metrics=result["metrics"],
             seconds=time.perf_counter() - t)
        torch.cuda.empty_cache()
    for seed in args.control_seeds:
        t = time.perf_counter()
        if train:
            rows, m, p, init, c_rows, c_m, c_p = _train_reading(
                params, model_cfg, seed, "cuda", tf32=True)
            numbers = checks.train_numbers(c_rows, c_m, c_p, init, rows, m,
                                           p)
        else:
            numbers = control_eval(params, model_cfg, seed, "cuda")
        _say(reading="control_tf32", seed=seed, numbers=numbers,
             seconds=time.perf_counter() - t)
        torch.cuda.empty_cache()
    if args.faults and train:
        half = slice(0, params["traffic"]["batch"] // 2)
        for seed in args.control_seeds:
            rows, m, p, init, h_rows, h_m, h_p = _train_reading(
                params, model_cfg, seed, "cuda", batch_slice=half)
            _say(reading="fault_half_batch", seed=seed,
                 numbers=checks.train_numbers(h_rows, h_m, h_p, init, rows,
                                              m, p))
            altered = [list(r) for r in rows]
            altered[-1][0] *= 1.01
            _say(reading="fault_altered_loss", seed=seed,
                 numbers=checks.train_numbers(altered, m, p, init, rows, m,
                                              p))
            zero = {n: torch.zeros_like(t) for n, t in m.items()}
            _say(reading="fault_state_unchanged", seed=seed,
                 numbers=checks.train_numbers(rows, zero, init, init, rows,
                                              m, p))
            torch.cuda.empty_cache()
    for seed in args.order_seeds if train else []:
        t = time.perf_counter()
        rows, m, p, init, o_rows, o_m, o_p = _train_reading(
            params, model_cfg, seed, "cuda", other_order=True)
        _say(reading="reference_other_order", seed=seed,
             numbers=checks.train_numbers(o_rows, o_m, o_p, init, rows, m,
                                          p),
             seconds=time.perf_counter() - t)
        torch.cuda.empty_cache()
    if args.late_faults and train:
        for seed in args.control_seeds:
            t = time.perf_counter()
            for fault, numbers in late_faults(params, model_cfg, seed,
                                              "cuda").items():
                _say(reading=f"fault_{fault}", seed=seed, numbers=numbers,
                     seconds=time.perf_counter() - t)
            torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
