"""The readings that a cell's limits are set from, in one process:

    python3 portbench/calibrate.py --workload <name> --seeds 1,2,3 --control-seeds 3

A cell not yet in ``BENCHMARK.json`` is named with its configuration and
traffic mix: ``--workload <new name> --config <config> --traffic <mix>``.

For each seed, the cell's inputs are drawn as a run draws them, the program
makes one call on each input set at the cell's size, and the check's numbers
are read as a run reads them (the sampled rows against the float64
reference). For the first ``--control-seeds`` seeds the control is read too:
the reference itself put in the program's place, in float32 with TF32
matrix products (the precision step below the configuration's float32), and
beside it the reference in plain float32. One JSON line per seed.
"""

import argparse
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from portbench import harness  # noqa: E402


def summary(per_set):
    import torch

    out = {}
    for name in per_set[0]:
        g = torch.cat([s[name] for s in per_set])
        out[name] = dict(max=float(g.max()), p99=float(g.quantile(0.99)),
                         p50=float(g.quantile(0.5)))
    return out


def main(argv=None):
    import torch

    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument('--workload', required=True)
    parser.add_argument('--seeds', required=True)
    parser.add_argument('--control-seeds', type=int, default=3)
    parser.add_argument('--config', help='configs/<config>.json, for a cell not in BENCHMARK.json')
    parser.add_argument('--traffic', help='traffic/<traffic>.json, with --config')
    args = parser.parse_args(argv)
    root = os.path.dirname(harness.PB_DIR)
    if args.traffic:
        spec = harness.make_cell(root, args.workload, f'portbench/configs/{args.config}.json',
                                 args.traffic)
    else:
        spec = harness.load_cell(root, args.workload)
    if not torch.cuda.is_available():
        print('calibrate: no CUDA device', file=sys.stderr)
        return 2
    ctx, program, _ = harness.prepare(spec, 'cuda')
    tr = spec.traffic
    for k, seed in enumerate(int(s) for s in args.seeds.split(',')):
        sets = harness.draw_inputs(spec, ctx, seed)
        results = [spec.entry.call(program, inp, tr) for inp in sets]
        torch.cuda.synchronize()
        samples = harness.sample_rows(spec, results, sets, seed)
        del results, sets
        torch.cuda.empty_cache()
        t0 = time.perf_counter()
        expected = harness.reference_outputs(spec, ctx, samples, torch.float64)
        torch.cuda.synchronize()
        line = dict(seed=seed, check_s=time.perf_counter() - t0, program=summary(
            harness.compare(spec, ctx, [out for out, _ in samples], expected)))
        if k < args.control_seeds:
            for name, tf32 in (('f32', False), ('control_tf32', True)):
                outs = harness.reference_outputs(spec, ctx, samples, torch.float32, tf32=tf32)
                outs = [{key: torch.cat([b[key] for b in blocks]) for key in blocks[0]}
                        for blocks in outs]
                line[name] = summary(harness.compare(spec, ctx, outs, expected))
        print(json.dumps(line), flush=True)
    return 0


if __name__ == '__main__':
    sys.exit(main())
