"""The benchmark's run of one cell of ``BENCHMARK.json``.

Everything that belongs to one configuration, traffic mix, entry, work count,
per-layer metric or limit sits in a file of its own, found by name:

- ``configs/<config>.json`` (the path ``BENCHMARK.json`` gives): the model;
- ``traffic/<traffic>.json``: the entry, the batch, the target sets, the
  call's keywords and the sizes of the check and the trace;
- ``entries/<entry>.py``: the program's set-up and call, the inputs, and the
  comparison with the plain reference (``reference.py``);
- ``work/<entry>.py``: the operations and bytes of the call's kernel stages;
- ``metrics/<metric>.py``: the reader of one per-layer metric;
- ``limits/<workload>.json``: the limit of each number the check compares;
- ``kernel_names/*.txt``: patterns of the port's own kernels beside the
  ``__global__`` names of ``smplfitter_tpu_torch/csrc``.

A run: write the model files once, build the program, draw the inputs on the
device from the seed, warm up, call the entry in a closed loop (one caller,
alternating the target sets, each call ending in a synchronise) for the
window, read the peak memory, with ``--trace 1`` profile a short stretch of
further calls, then check the sampled rows of the last call on each set
against the plain reference in float64 and print the result line.
"""

from __future__ import annotations

import argparse
import importlib.util
import json
import os
import statistics
import subprocess
import sys
import time
from types import SimpleNamespace

PB_DIR = os.path.dirname(os.path.abspath(__file__))
FORBIDDEN = ('jax', 'jaxlib', 'flax', 'optax', 'smplfitter_tpu')
# Keys of every traffic file; an entry adds its own (``TRAFFIC_KEYS``).
TRAFFIC_KEYS = ('entry', 'batch', 'target_sets', 'profile_calls', 'check_rows', 'check_block')


def load_module(path: str, name: str):
    spec = importlib.util.spec_from_file_location(name, path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def read_json(path: str):
    with open(path) as f:
        return json.load(f)


def load_cell(root: str, workload: str) -> SimpleNamespace:
    """The cell named ``workload`` of ``BENCHMARK.json`` and every file of its
    own, found by name."""
    bench = read_json(os.path.join(root, 'BENCHMARK.json'))
    cells = {w['name']: w for w in bench['workloads']}
    if workload not in cells:
        raise SystemExit(f'unknown workload {workload!r}; known: {sorted(cells)}')
    cell = cells[workload]
    config_entry = next(c for c in bench['configs'] if c['name'] == cell['config'])

    def applies(metric):
        return workload in metric.get('workloads', [workload])

    spec = make_cell(root, workload, config_entry['file'], cell['traffic'], cell['chips'])
    spec.limits = read_json(os.path.join(PB_DIR, 'limits', workload + '.json'))
    spec.end_to_end = [m for m in bench['end_to_end'] if applies(m)]
    spec.per_layer = [m for m in bench['per_layer'] if applies(m)]
    return spec


def make_cell(root: str, name: str, config_file: str, traffic_name: str,
              chips: int = 1) -> SimpleNamespace:
    """A cell from its configuration file (relative to ``root``) and traffic
    mix, in ``BENCHMARK.json`` or not yet: without limits or metrics."""
    traffic = read_json(os.path.join(PB_DIR, 'traffic', traffic_name + '.json'))
    entry_name = traffic['entry']
    entry = load_module(os.path.join(PB_DIR, 'entries', entry_name + '.py'),
                        f'pb_entry_{entry_name}')
    unknown = set(traffic) - set(TRAFFIC_KEYS) - set(entry.TRAFFIC_KEYS)
    if unknown:
        raise SystemExit(f'traffic {traffic_name!r}: keys {sorted(unknown)} are read by nothing')
    return SimpleNamespace(
        name=name, cell=dict(name=name, traffic=traffic_name, chips=chips), root=root,
        config=read_json(os.path.join(root, config_file)), traffic=traffic, limits={},
        entry=entry,
        work=load_module(os.path.join(PB_DIR, 'work', entry_name + '.py'), f'pb_work_{entry_name}'),
        end_to_end=[], per_layer=[])


def sync(device) -> None:
    import torch

    if torch.device(device).type == 'cuda':
        torch.cuda.synchronize()


def shapes(ref, traffic) -> dict:
    """The cell's shapes for its work count, from the reference model."""
    import torch

    adjustable = [j for j in (1, 2, 4, 5, 7, 8, 16, 17, 18, 19) if j < ref.J]
    used_parts = torch.tensor(sorted(set(ref.bones + ref.leaves + adjustable)),
                              device=ref.part_of_vertex.device)
    used = torch.isin(ref.part_of_vertex, used_parts)
    nz = ref.weights != 0
    return dict(B=traffic['batch'], V=ref.V, J=ref.J, E=ref.E, P=(ref.J - 1) * 9,
                nnz=int(nz.sum()), used=int(used.sum()), nnz_used=int(nz[used].sum()),
                num_iter=traffic.get('fit', {}).get('num_iter', 1),
                weighted=bool(traffic.get('weights')))


def quartiles_text(values) -> str:
    if len(values) < 2:
        return ' '.join(f'{v:.6g}' for v in values)
    q = statistics.quantiles(values, n=4)
    return f'min {min(values):.6g} q1 {q[0]:.6g} median {q[1]:.6g} q3 {q[2]:.6g} max {max(values):.6g}'


def prepare(spec, device):
    """The run's context, the program under test and the cell's shapes."""
    import torch

    from portbench import synth
    from portbench.reference import RefModel

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg = spec.config
    ctx = SimpleNamespace(config=cfg, traffic=spec.traffic, device=device,
                          model_root=synth.ensure_model_files(
                              os.path.join(PB_DIR, '_models'), cfg))
    program = spec.entry.setup(ctx)
    ctx.ref32 = RefModel(ctx.model_root, cfg['model'], cfg['num_betas'], device,
                         torch.float32)
    return ctx, program, shapes(ctx.ref32, spec.traffic)


def draw_inputs(spec, ctx, seed: int):
    """The traffic's input sets, drawn on the device from ``seed``."""
    import torch

    gen = torch.Generator(device=ctx.device)
    gen.manual_seed(seed)
    return spec.entry.make_inputs(ctx, ctx.ref32, gen)


def sample_rows(spec, results, sets, seed: int):
    """[(outputs, inputs)] of each set's rows drawn from ``seed``, copied."""
    import torch

    rows_gen = torch.Generator().manual_seed(seed)
    samples = []
    for result, inp in zip(results, sets):
        B = spec.traffic['batch']
        rows = torch.randperm(B, generator=rows_gen)[:spec.traffic['check_rows']].sort().values
        samples.append(spec.entry.rows_of(result, inp, rows.to(next(iter(inp.values())).device)))
    return samples


def blocks(d, step):
    n = len(next(iter(d.values())))
    return [{k: v[s:s + step] for k, v in d.items()} for s in range(0, n, step)]


def reference_outputs(spec, ctx, samples, dtype, tf32: bool = False):
    """Per set, the plain reference's outputs of the sampled inputs at
    ``dtype`` (with TF32 matrix products where ``tf32``), in blocks of rows."""
    import torch

    from portbench.reference import RefModel

    cfg, tr = ctx.config, ctx.traffic
    ref = RefModel(ctx.model_root, cfg['model'], cfg['num_betas'], ctx.device, dtype)
    torch.backends.cuda.matmul.allow_tf32 = tf32
    try:
        return [[spec.entry.reference(ref, inp, tr) for inp in blocks(inp, tr['check_block'])]
                for _, inp in samples]
    finally:
        torch.backends.cuda.matmul.allow_tf32 = False


def compare(spec, ctx, outs, expected):
    """Per set, {number: per-row gaps} of ``outs`` (one outputs dict per set)
    from ``expected`` (reference_outputs), measured by the float64 reference."""
    import torch

    from portbench.reference import RefModel

    cfg = ctx.config
    ref = RefModel(ctx.model_root, cfg['model'], cfg['num_betas'], ctx.device, torch.float64)
    step = spec.traffic['check_block']
    per_set = []
    for out, exp in zip(outs, expected):
        parts = [spec.entry.gaps(o, e, ref) for o, e in zip(blocks(out, step), exp)]
        per_set.append({name: torch.cat([p[name].detach().to('cpu', torch.float64)
                                         for p in parts]) for name in parts[0]})
    return per_set


def judge(spec, per_set, log):
    """Each compared number (the largest gap over all sampled rows) beside its
    limit, and the count of sampled rows that put a number over its limit."""
    import torch

    gaps = {name: torch.cat([g[name] for g in per_set]) for name in per_set[0]}
    for name, g in gaps.items():
        log(f'{name} over rows: p50 {float(g.quantile(0.5)):.6g} '
            f'p99 {float(g.quantile(0.99)):.6g} max {float(g.max()):.6g}')
    checks = {name: dict(value=float(gaps[name].max()), limit=lim['limit'])
              for name, lim in spec.limits.items()}
    # A NaN gap is over every limit: ``<=`` is false for it.
    over = torch.zeros(len(next(iter(gaps.values()))), dtype=torch.bool)
    for name, lim in spec.limits.items():
        over |= ~(gaps[name] <= lim['limit'])
    return checks, int(over.sum())


def run(spec, seed: int, seconds: float, trace: bool, device: str, t_start: float,
        log=None) -> dict:
    """One run of a cell; returns the result line's fields and the checks."""
    import torch

    from portbench.yardstick import PEAK_F32_FLOPS, flops, least_seconds

    log = log or (lambda msg: print(msg, file=sys.stderr, flush=True))
    tr = spec.traffic
    is_cuda = torch.device(device).type == 'cuda'
    log(f'set-up: torch imported at {time.perf_counter() - t_start:.3f} s')
    ctx, program, cell_shapes = prepare(spec, device)
    log(f'set-up: model files, program and reference model at {time.perf_counter() - t_start:.3f} s')
    sets = draw_inputs(spec, ctx, seed)
    sync(device)
    log(f'set-up: inputs drawn at {time.perf_counter() - t_start:.3f} s')
    n_sets = len(sets)
    B = tr['batch']

    def call(i):
        return spec.entry.call(program, sets[i % n_sets], tr)

    # Warm-up: one call on each input set, so that both sets' buffers are in
    # the allocator before the window.
    kept = [None] * n_sets
    for i in range(n_sets):
        kept[i] = call(i)
        sync(device)
    if is_cuda:
        torch.cuda.reset_peak_memory_stats()
    setup_s = time.perf_counter() - t_start
    log(f'set-up {setup_s:.3f} s; window {seconds} s at B={B}, {n_sets} sets')

    latencies = []
    t0 = time.perf_counter()
    i = 0
    while True:
        t_call = time.perf_counter()
        kept[i % n_sets] = call(i)
        sync(device)
        t_end = time.perf_counter()
        latencies.append(t_end - t_call)
        i += 1
        if t_end - t0 >= seconds:
            break
    window = t_end - t0
    calls = len(latencies)
    peak = torch.cuda.max_memory_allocated() if is_cuda else 0
    log(f'window {window:.6f} s, {calls} calls; call s: {quartiles_text(latencies)}')

    reading = None
    if trace:
        from portbench.trace import profile_calls

        work = spec.work.stages(cell_shapes)
        t_prof = time.perf_counter()
        reading = profile_calls(lambda k: call(i + k), tr['profile_calls'], device,
                                kernel_patterns(spec.root))
        log(f'profile and its reading {time.perf_counter() - t_prof:.3f} s')
        reading.least_s = least_seconds(work)
        reading.flops = flops(work)
        reading.wall_s_per_call = window / calls
        reading.peak_flops = PEAK_F32_FLOPS
        log(f'profiled {reading.calls} calls: {len(reading.events)} device events, '
            f'busy {reading.busy_s:.6f} s of {reading.window_s:.6f} s')
        log('work per call: ' + ', '.join(f'{n} {f:.6g} flop {b:.6g} B' for n, f, b in work))

    # The check: sampled rows of the last call on each set; the program and
    # its inputs are freed before the reference runs, in blocks of rows.
    samples = sample_rows(spec, kept, sets, seed)
    del kept, sets, program
    ctx.ref32 = None
    if is_cuda:
        torch.cuda.empty_cache()
    t_check = time.perf_counter()
    expected = reference_outputs(spec, ctx, samples, torch.float64)
    per_set = compare(spec, ctx, [out for out, _ in samples], expected)
    log(f'check {time.perf_counter() - t_check:.3f} s over {n_sets} x {tr["check_rows"]} rows')
    checks, failed = judge(spec, per_set, log)
    rows = sum(len(next(iter(g.values()))) for g in per_set)
    return dict(correct=failed == 0, attempted=rows, failed=failed, setup_s=setup_s,
                window_s=window, calls=calls, latencies=latencies, bodies=calls * B,
                peak=peak, reading=reading, checks=checks, shapes=cell_shapes)


def kernel_patterns(root: str) -> list:
    """Regular expressions of the port's own kernels: each ``__global__``
    function of ``smplfitter_tpu_torch/csrc`` by name, and every line of the
    pattern files under ``kernel_names/`` (``#`` starts a comment)."""
    import re

    pats = []
    csrc = os.path.join(root, 'smplfitter_tpu_torch', 'csrc')
    glob_re = re.compile(r'__global__\s+void\s+(?:__launch_bounds__\s*\([^)]*\)\s*)?(\w+)')
    for fname in sorted(os.listdir(csrc)):
        if fname.endswith(('.cu', '.cuh')):
            with open(os.path.join(csrc, fname)) as f:
                pats += [r'\b' + n + r'\b' for n in glob_re.findall(f.read())]
    kdir = os.path.join(PB_DIR, 'kernel_names')
    for fname in sorted(os.listdir(kdir)):
        if fname.endswith('.txt'):
            with open(os.path.join(kdir, fname)) as f:
                pats += [ln.strip() for ln in f if ln.strip() and not ln.startswith('#')]
    return pats


def power_limit() -> str:
    try:
        out = subprocess.run(['nvidia-smi', '--query-gpu=name,power.limit',
                              '--format=csv,noheader'], capture_output=True, text=True,
                             timeout=30)
        return out.stdout.strip().splitlines()[0] if out.returncode == 0 else 'not read'
    except (OSError, subprocess.SubprocessError, IndexError):
        return 'not read'


def end_to_end_values(res) -> dict:
    lat_ms = [x * 1e3 for x in res['latencies']]
    p90 = statistics.quantiles(lat_ms, n=10)[8] if len(lat_ms) >= 2 else lat_ms[0]
    return dict(bodies_per_s=res['bodies'] / res['window_s'], call_ms_p90=p90,
                peak_mem_gib=res['peak'] / 2 ** 30, setup_s=res['setup_s'])


def forbidden_modules(names=None) -> list:
    """The forbidden top-level names among ``names`` (default: the loaded
    modules), each compared whole: ``smplfitter_tpu_torch`` is not
    ``smplfitter_tpu``."""
    names = list(sys.modules) if names is None else names
    return sorted({name.split('.')[0] for name in names} & set(FORBIDDEN))


def main(argv, t_start: float) -> int:
    parser = argparse.ArgumentParser(description='Run one cell of BENCHMARK.json.')
    parser.add_argument('--workload', required=True)
    parser.add_argument('--seed', type=int, required=True)
    parser.add_argument('--seconds', type=float, required=True)
    parser.add_argument('--trace', type=int, choices=(0, 1), default=0)
    args = parser.parse_args(argv)
    root = os.path.dirname(PB_DIR)
    # Build and kernel caches live at fixed paths inside the checkout.
    os.environ['TRITON_CACHE_DIR'] = os.path.join(PB_DIR, '_cache', 'triton')
    os.environ['TORCH_EXTENSIONS_DIR'] = os.path.join(PB_DIR, '_cache', 'torch_extensions')
    spec = load_cell(root, args.workload)

    import torch

    chips = spec.cell['chips']
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        found = torch.cuda.device_count() if torch.cuda.is_available() else 0
        print(f'portbench: the cell needs {chips} CUDA device(s), found {found}; '
              'no result without the card', file=sys.stderr)
        return 2
    res = run(spec, args.seed, args.seconds, bool(args.trace), 'cuda', t_start)
    bad = forbidden_modules()
    if bad:
        print(f'portbench: the run loaded {bad}, which the port must not import', file=sys.stderr)
        return 3

    device = dict(platform='gpu', kind=torch.cuda.get_device_name(0), count=chips,
                  memory_peak_bytes=int(res['peak']))
    power = power_limit()
    device['power_limit'] = power
    e2e = end_to_end_values(res)
    print(f'end to end: {json.dumps(e2e)}; calls {res["calls"]} (call_ms_p90 over '
          f'{res["calls"]} samples); card {power}', file=sys.stderr)
    # attempted / failed: the sampled rows checked and those over a limit.
    line = dict(correct=res['correct'], attempted=res['attempted'], failed=res['failed'],
                calls=res['calls'])
    if args.trace:
        from portbench.trace import breakdown, per_layer_values

        reading = res['reading']
        metrics = per_layer_values(spec, reading)
        device['busy_s'] = reading.busy_s
        device['window_s'] = reading.window_s
        line['metrics'] = metrics
        line['device'] = device
        line['breakdown'] = breakdown(reading)
    else:
        line['metrics'] = {m['name']: dict(value=e2e[m['name']], unit=m['unit'])
                           for m in spec.end_to_end}
        line['device'] = device
    line['checks'] = res['checks']
    for name, c in res['checks'].items():
        ok = 'ok' if c['value'] <= c['limit'] else 'OVER'
        print(f'check {name} {c["value"]!r} limit {c["limit"]!r} {ok}', file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(line), flush=True)
    return 0
