"""Serving launcher: ``python -m repro_torch.launch.serve --arch <id>``.

LM mode (``--arch llama3.2-1b``, the other dense configs, ``minicpm3-4b``
(MLA), the MoE configs ``qwen3-moe-30b-a3b`` and ``phi3.5-moe-42b-a6.6b``,
``falcon-mamba-7b`` and ``zamba2-2.7b``): the port of
``repro.launch.serve.serve_lm``. Random weights from seed 0, drawn on the
device, in f32 (the reference's server forces ``dtype="float32"``); the
continuous-batching :class:`~repro_torch.serve.Engine` with ``--slots``
slots, ``--max-len`` positions and prompt buckets 8/16/32/64 serves
``--requests`` prompts of the reference's (``default_rng(0)``, lengths 2-23,
uniform token ids), ``--max-new`` tokens each, greedy. Prefill attention
runs kernel K4 on the card, an ssm model's prefill scan kernel K5; TF32
products are switched off. Prints tokens per second over the whole run,
the prefill and decode-step p50 (host clock, each ended by a device
synchronise) and K4's and K5's launches. The first prefill pays the
kernel's build when it is not built yet. An ssm or hybrid model
(falcon-mamba-7b, zamba2-2.7b) refuses those prompts as the reference's
server does: its engine takes only contexts of a bucket's exact length, and
the first prompt that is not raises ``ValueError`` with the reference's
message. ``whisper-large-v3`` (encdec) and ``pixtral-12b`` (vlm) need the
frontend stubs' inputs, which a prompt does not carry: the server exits
with the reference's message, and ``Model.prefill`` / ``decode_step`` serve
them (``data.synthetic.lm_batch`` makes the inputs).

Image mode: one request is one batch of ``--slots`` synthetic frames
(``data.synthetic.image_batch``) through :func:`repro_torch.api.edge_detect`
with the arch's ``EdgeConfig`` plus ``with_max``. One warm-up request runs
first (it also builds the CUDA kernels on first use); then every request's
host-to-device transfer and its compute are timed separately, each ended by
a device synchronise. Prints megapixels per second over the compute time
and the p50/p95 of both, as ``repro.launch.serve`` does. ``--edges`` serves
binary edge maps instead: NMS fused into K1, hysteresis linking after it,
and the edge density of the last request.

Multi-device serving, ``--shard DxRxC`` (or the arch's ``sobel_shard``):
every request spreads over the image mesh, D batch groups x an RxC spatial
grid with halo exchange (``repro_torch.sharding.halo``), one K1 (or K2)
launch per shard. The mesh is a grid of ``torch.device`` objects in this
process: every visible CUDA device, or a logical list passed to
:func:`main` (``[cuda:0] * 8`` runs 2x2x2 on one card). The loop is
elastic: a device loss replans the mesh (``runtime.elastic``: the spatial
grid survives, ``data`` shrinks) and re-warms outside the latency window.
``--simulate-loss-at N`` is the chaos entry ``loss@N``.

Fault drills, ``--chaos PLAN`` (DSL in ``runtime/chaos.py``): each request
runs under ``serve/guard.py``'s bounded retries; injected stragglers
(``slow@dK:MS``) are flagged by ``StepMonitor`` and excluded by
``StragglerPolicy`` (another replan). Every image run prints a ``health:``
line accounting for each request; under ``--chaos`` an unaccounted one
exits non-zero. There is no ``cuda`` -> ``torch`` fallback: a failure that
outlasts the retries raises after the ``health:`` line.

Streaming mode, ``--streams N``: N synthetic camera streams
(``data.synthetic.video_frame``, ``--motion`` px per frame) push
``--requests`` frames each at ``--fps`` through the
:class:`~repro_torch.serve.StreamEngine` (NMS and hysteresis always on,
per-tile delta-skip through K3; ``--decay`` > 0 turns on temporal
hysteresis). Prints per-stream compute and transfer p50/p99, the skip rate
and the engine's health ledger.

Runs on the CUDA device by default; ``--device cpu`` runs the plain
PyTorch version. There is no fallback between the two: the image server
and the stream engine retry a failing step (``serve/guard.py``) and then
raise, and their health lines report the retries. ``main`` returns what it
printed as a dict.
"""
from __future__ import annotations

import argparse
import time
from typing import Optional, Sequence

import numpy as np
import torch

from repro_torch.configs import get_config

LM_BUCKETS = (8, 16, 32, 64)   # the reference server's prompt buckets


def _percentile(xs, q):
    return float(np.percentile(np.asarray(xs), q))


def _parse_chaos(args):
    """The merged fault plan of this run (``--chaos`` and the older
    ``--simulate-loss-at N``, which is the plan entry ``loss@N``)."""
    from repro_torch.runtime.chaos import DeviceLoss, FaultPlan

    plan = FaultPlan.parse(args.chaos) if args.chaos else None
    if args.simulate_loss_at:
        base = plan or FaultPlan()
        plan = FaultPlan(base.faults + (DeviceLoss(step=args.simulate_loss_at),),
                         seed=base.seed)
    return plan


def _server_devices(args, devices) -> list:
    """The server's device list: ``devices`` when the caller passes one
    (tests and ``chip_smoke.py`` pass logical lists such as ``[cuda:0] *
    8``), else every visible CUDA device, or the one CPU device under
    ``--device cpu``."""
    from repro_torch.kernels.dispatch import resolve_device
    from repro_torch.runtime.elastic import visible_devices

    if devices is None:
        device = resolve_device(args.device)
        return [device] if device.type == "cpu" else visible_devices()
    devices = [torch.device(d) for d in devices]
    kinds = {d.type for d in devices} | {torch.device(args.device).type}
    if not devices or len(kinds) > 1:
        raise ValueError(f"devices={devices} do not match --device {args.device}")
    return [resolve_device(d) for d in devices]


def serve_image(cfg, args, devices=None) -> dict:
    """Edge-detection serving: one request is one batch of frames.

    Each request runs under the guard (``serve/guard.py``): bounded retries
    with backoff and no fallback, so a failure that outlasts them raises,
    after the ``health:`` line. A ``--chaos`` plan can shrink the device
    population mid-run (an elastic replan of the image mesh, then a re-warm
    outside the latency window) and straggle single devices
    (``slow@dK:MS``); ``StepMonitor`` flags a straggler and, after repeated
    strikes, ``StragglerPolicy`` excludes it from the mesh (another replan).
    ``devices`` is the logical device list (see :func:`_server_devices`).
    Returns the numbers it printed, the health ledger and the last
    request's :class:`~repro_torch.api.EdgeResult`.
    """
    from repro_torch.api import ShardConfig, edge_detect
    from repro_torch.data.synthetic import image_batch
    from repro_torch.kernels.dispatch import resolve_backend
    from repro_torch.runtime.elastic import make_image_mesh, plan_image_mesh
    from repro_torch.runtime.monitor import StepMonitor
    from repro_torch.runtime.stragglers import StragglerPolicy
    from repro_torch.serve.guard import GuardPolicy, Health, StepGuard

    chaos = _parse_chaos(args)
    overrides = dict(with_max=True)
    if args.edges:
        # Detector traffic: NMS fused into the kernel pass, hysteresis
        # linking after it; requests return binary edge maps.
        overrides.update(nms=True, hysteresis=True)
    edge_cfg = cfg.edge_config(**overrides).resolved()
    shard_spec = args.shard if args.shard is not None else cfg.sobel_shard
    shard = ShardConfig.parse(shard_spec) if shard_spec else None
    all_devices = _server_devices(args, devices)
    device = all_devices[0]
    backend = resolve_backend(edge_cfg.backend, device)
    pop = list(range(len(all_devices)))  # surviving device ids, the d<i> tags
    if shard is not None:
        # Strict at startup: a spec that does not fit is a config error.
        # Shrinking is for a device loss or an excluded straggler mid-run.
        shard.resolve(len(pop))
    print(
        f"serving {cfg.name}: operator={edge_cfg.operator} "
        f"variant={edge_cfg.variant} directions={edge_cfg.directions} "
        f"backend={backend} {cfg.image_h}x{cfg.image_w} device={device} "
        f"devices={len(pop)} shard={shard_spec or 'none'}"
        f"{' mode=edges (NMS+hysteresis)' if args.edges else ''}"
        f"{f' chaos={args.chaos!r}' if args.chaos else ''}"
    )

    health = Health(backend=backend)
    monitor = StepMonitor(window=8)
    straggler_policy = StragglerPolicy()
    mesh = None
    meshes = []

    def build_step(devs):
        """The mesh for the current device population (None: one device)."""
        if shard is None:
            return None
        (d, r, c), _ = plan_image_mesh(len(devs), rows=shard.rows, cols=shard.cols,
                                       data=shard.data)
        print(f"image mesh: data={d} row={r} col={c} on {d * r * c} device(s)")
        meshes.append((d, r, c))
        return make_image_mesh(devs, rows=r, cols=c, data=d)

    def sync():
        for dev in {d for d in all_devices if d.type == "cuda"}:
            torch.cuda.synchronize(dev)

    def step(frames):
        out = edge_detect(frames, edge_cfg, device=device, mesh=mesh)
        sync()
        return out

    guard = StepGuard(step, policy=GuardPolicy(), chaos=chaos,
                      seed=chaos.seed if chaos is not None else 0)

    def request(req):
        return torch.from_numpy(image_batch(cfg, batch=args.slots, step=req)["images"])

    def place(host):
        """The frames on the device they land on: the mesh's first device,
        which scatters each shard's block to its own device in the call."""
        return host.to(mesh.lead if mesh is not None else device)

    rewarm_ms = []

    def warm(req):
        """Pay the first use (and the kernels' build) outside the latency
        window, through the guard as a request is; returns its ms, the
        frames' synthesis left out."""
        host = request(req)
        t0 = time.perf_counter()
        guard(place(host))
        return (time.perf_counter() - t0) * 1e3

    def replan(keep, why):
        nonlocal mesh, pop
        survivors = pop[:keep]
        print(f"{why}: {len(pop)} -> {len(survivors)} devices; "
              "replanning mesh and resharding")
        pop = survivors
        mesh = build_step([all_devices[i] for i in pop])
        health.replans += 1

    lat_ms, xfer_ms = [], []
    px_total = 0
    excluded = set()
    out = None
    try:
        mesh = build_step([all_devices[i] for i in pop])
        warm(0)
        t_all = time.perf_counter()
        for req in range(args.requests):
            if chaos is not None:
                loss = chaos.device_loss(req)
                if loss is not None:
                    replan(loss.survivors(len(pop)), "device loss")
                    rewarm_ms.append(warm(req))
            host = request(req)
            # Transfer and compute are timed apart, each ended by a device
            # synchronise.
            t_x = time.perf_counter()
            frames = place(host)
            sync()
            xfer_ms.append((time.perf_counter() - t_x) * 1e3)
            t0 = time.perf_counter()
            health.submitted += 1
            out, kind, attempts = guard(frames)
            base_s = time.perf_counter() - t0
            health.record(kind)
            health.retries += attempts
            # Injected stragglers: the slowest device gates the request (one
            # sleep), but the monitor sees each device's own time, so the
            # policy blames the right one.
            lag = 0.0
            if chaos is not None:
                delays = [chaos.delay_s(f"d{i}", req) for i in pop]
                lag = max(delays)
                if lag > 0:
                    time.sleep(lag)
                for i, own in zip(pop, delays):
                    monitor.record(f"d{i}", base_s + own)
                for tag in monitor.stragglers():
                    if tag not in health.stragglers:
                        health.stragglers.append(tag)
                for tag in straggler_policy.step(monitor)["exclude"]:
                    if tag in excluded or len(pop) <= 1:
                        continue
                    excluded.add(tag)
                    health.excluded.append(tag)
                    pop = [i for i in pop if f"d{i}" != tag]
                    replan(len(pop), f"excluding straggler {tag}")
                    rewarm_ms.append(warm(req))
            lat_ms.append(base_s * 1e3 + lag * 1e3)
            px_total += frames.shape[0] * cfg.image_h * cfg.image_w
        wall = time.perf_counter() - t_all
    except Exception as err:
        # No fallback: the failure stands, after the ledger says where.
        health.errors.append(f"{type(err).__name__}: {err}")
        print(health.summary())
        raise
    if not lat_ms:
        print(f"0 requests served in {wall:.2f}s (warm-up only; "
              "use --requests >= 1 for steady-state numbers)")
        return {"requests": 0, "result": None, "health": health}
    stats = {
        "requests": args.requests,
        "slots": args.slots,
        "mps": px_total / 1e6 / (sum(lat_ms) / 1e3),
        "compute_p50_ms": _percentile(lat_ms, 50),
        "compute_p95_ms": _percentile(lat_ms, 95),
        "transfer_p50_ms": _percentile(xfer_ms, 50),
        "transfer_p95_ms": _percentile(xfer_ms, 95),
        "meshes": meshes,
        "rewarm_ms": rewarm_ms,
        "health": health,
        "result": out,
    }
    tag = " (served through reshard)" if health.replans else ""
    if args.edges:
        # The edge-pixel density of the last request: a blank camera or a
        # threshold misconfiguration shows up as 0.0 or ~1.0.
        stats["edge_density"] = float(out.edges.float().mean())
        tag += f"; edge density={stats['edge_density']:.3f}"
    print(
        f"{args.requests} requests x {args.slots} frames, {wall:.2f}s -> "
        f"{stats['mps']:.1f} MPS; compute p50={stats['compute_p50_ms']:.1f}ms "
        f"p95={stats['compute_p95_ms']:.1f}ms; transfer "
        f"p50={stats['transfer_p50_ms']:.1f}ms "
        f"p95={stats['transfer_p95_ms']:.1f}ms{tag}"
    )
    print(health.summary())
    if chaos is not None and health.unaccounted:
        raise SystemExit(f"chaos run left {health.unaccounted} request(s) unaccounted")
    return stats


def serve_streams(cfg, args) -> dict:
    """Streaming video serving: ``args.streams`` camera streams, fps-paced.

    Each stream is a synthetic camera (``data.synthetic.video_frame``)
    pushing ``--requests`` frames at ``--fps``; the engine batches the
    same-resolution streams, delta-skips unchanged tiles against each
    stream's cached state and, with ``--decay`` > 0, carries temporal
    hysteresis seeds across frames. Returns the per-stream stats, the
    engine's health ledger and the numbers printed.
    """
    from repro_torch.data.synthetic import video_frame
    from repro_torch.kernels.dispatch import resolve_backend, resolve_device
    from repro_torch.serve import StreamEngine, StreamRequest

    device = resolve_device(args.device)
    overrides = dict(with_max=True, nms=True, hysteresis=True)
    if args.decay > 0:
        overrides.update(temporal=True, decay=args.decay)
    edge_cfg = cfg.edge_config(**overrides).resolved()
    print(
        f"streaming {cfg.name}: operator={edge_cfg.operator} "
        f"variant={edge_cfg.variant} backend={resolve_backend(edge_cfg.backend, device)} "
        f"{cfg.image_h}x{cfg.image_w} streams={args.streams} "
        f"slots={args.slots} fps={args.fps} frames/stream={args.requests} "
        f"motion={args.motion} device={device}"
        f"{f' temporal decay={args.decay}' if args.decay > 0 else ''}"
        f"{f' chaos={args.chaos!r}' if args.chaos else ''}"
    )

    def source(sid):
        def frame(i):
            if i >= args.requests:
                return None
            return video_frame(cfg, stream=sid, step=i, motion=args.motion)
        return frame

    engine = StreamEngine(edge_cfg, max_streams=args.slots, collect=args.collect,
                          chaos=_parse_chaos(args), device=device)
    for sid in range(args.streams):
        engine.submit(StreamRequest(sid=sid, frames=source(sid), fps=args.fps))
    t0 = time.perf_counter()
    stats = engine.run()
    wall = time.perf_counter() - t0

    frames_total = skipped = tiles = 0
    per_stream = {}
    for sid in sorted(stats):
        st = stats[sid]
        frames_total += st.frames
        skipped += st.skipped_tiles
        tiles += st.tiles_per_frame * max(0, st.frames - 1)
        # The first sample per stream pays the kernels' build and the cold
        # cache fill; leave it out of the steady-state percentiles.
        warm = min(1, max(0, st.frames - 1))
        comp = st.compute_ms[warm:] or st.compute_ms
        xfer = st.transfer_ms[warm:] or st.transfer_ms
        row = dict(frames=st.frames, skip_rate=st.skip_rate, cached=st.cached_steps,
                   compute_p50_ms=_percentile(comp, 50), compute_p99_ms=_percentile(comp, 99),
                   transfer_p50_ms=_percentile(xfer, 50), transfer_p99_ms=_percentile(xfer, 99))
        per_stream[sid] = row
        drops = (f" shed={st.shed} quarantined={st.quarantined}"
                 if st.shed or st.quarantined else "")
        print(
            f"  stream {sid}: {st.frames} frames, skip={st.skip_rate:.0%} "
            f"cached={st.cached_steps};{drops} compute "
            f"p50={row['compute_p50_ms']:.2f}ms p99={row['compute_p99_ms']:.2f}ms; "
            f"transfer p50={row['transfer_p50_ms']:.2f}ms "
            f"p99={row['transfer_p99_ms']:.2f}ms "
            f"(budget {st.budget_ms:.1f}ms)"
        )
    fps_served = frames_total / wall if wall > 0 else 0.0
    print(f"{len(stats)} streams x {args.requests} frames in {wall:.2f}s "
          f"-> {fps_served:.1f} frames/s aggregate")
    print(engine.health.summary())
    if engine.chaos is not None and engine.health.unaccounted:
        raise SystemExit(
            f"chaos run left {engine.health.unaccounted} frame(s) unaccounted"
        )
    return {
        "streams": stats,
        "per_stream": per_stream,
        "health": engine.health,
        "skip_rate": skipped / tiles if tiles else 0.0,
        "frames_per_s": fps_served,
        "config": edge_cfg,
    }


def serve_lm(cfg, args) -> dict:
    """Serve ``args.requests`` prompts through the LM engine; returns the
    numbers it printed, the finished requests and the weights."""
    from repro_torch.kernels.dispatch import resolve_device
    from repro_torch.kernels.flash_attention import flash_attention
    from repro_torch.kernels.selective_scan import selective_scan
    from repro_torch.models import Model
    from repro_torch.serve import Engine, Request

    device = resolve_device(args.device)
    # Full-f32 products: a TF32 product would move the logits by ~1e-3.
    torch.backends.cuda.matmul.allow_tf32 = False
    model = Model(cfg)
    params = model.init(0, device=device)
    n_params = model.param_count()
    print(f"serving {cfg.name}: {n_params:,} params, {args.slots} slots, device={device}")

    engine = Engine(cfg, params, max_batch=args.slots, max_len=args.max_len,
                    prompt_buckets=LM_BUCKETS, device=device)
    rng = np.random.default_rng(0)
    for uid in range(args.requests):
        plen = int(rng.integers(2, 24))
        engine.submit(Request(uid=uid, prompt=rng.integers(0, cfg.vocab_size, plen).tolist(),
                              max_new_tokens=args.max_new))
    k4_before, k5_before = flash_attention.launches, selective_scan.launches
    t0 = time.perf_counter()
    done = engine.run()
    dt = time.perf_counter() - t0
    toks = sum(len(r.output) for r in done)
    stats = {
        "requests": done,
        "tokens": toks,
        "seconds": dt,
        "tok_s": toks / dt if dt > 0 else 0.0,
        "prefills": len(engine.prefill_ms),
        "decode_steps": len(engine.decode_ms),
        "prefill_p50_ms": _percentile(engine.prefill_ms, 50) if engine.prefill_ms else 0.0,
        "decode_p50_ms": _percentile(engine.decode_ms, 50) if engine.decode_ms else 0.0,
        "k4_launches": flash_attention.launches - k4_before,
        "k5_launches": selective_scan.launches - k5_before,
        "param_count": n_params,
        "params": params,
    }
    print(f"{len(done)} requests, {toks} tokens, {dt:.2f}s -> {stats['tok_s']:.1f} tok/s; "
          f"prefill p50={stats['prefill_p50_ms']:.2f}ms ({stats['prefills']} prefills); "
          f"decode step p50={stats['decode_p50_ms']:.2f}ms ({stats['decode_steps']} steps); "
          f"K4 launches {stats['k4_launches']}, K5 launches {stats['k5_launches']}")
    return stats


def main(argv: Optional[Sequence[str]] = None, devices: Optional[Sequence] = None) -> dict:
    """Parse ``argv`` and serve; returns what was printed, as a dict.
    ``devices`` is the image server's logical device list (default: every
    visible CUDA device, or the CPU under ``--device cpu``); a device may
    repeat, so ``[torch.device("cuda:0")] * 8`` runs a 2x2x2 mesh on one
    card."""
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", required=True)
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--requests", type=int, default=16)
    ap.add_argument("--slots", type=int, default=4,
                    help="frames per request (image), engine slots (LM)")
    ap.add_argument("--max-new", type=int, default=16, help="tokens per request (LM)")
    ap.add_argument("--max-len", type=int, default=256, help="cache positions per slot (LM)")
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    ap.add_argument("--edges", action="store_true",
                    help="serve binary edge maps (fused NMS + hysteresis) instead of "
                         "magnitude")
    ap.add_argument("--streams", type=int, default=0, metavar="N",
                    help="serve N concurrent video streams through the streaming engine "
                         "(per-stream temporal state + delta-skip); --requests = frames "
                         "per stream, --slots = concurrent streams")
    ap.add_argument("--fps", type=float, default=30.0,
                    help="per-stream frame rate budget (with --streams)")
    ap.add_argument("--decay", type=float, default=0.0,
                    help="temporal hysteresis seed decay in [0,1); 0 = stateless "
                         "per-frame detection (with --streams)")
    ap.add_argument("--motion", type=float, default=2.0,
                    help="synthetic camera motion in px/frame; 0 = static streams, the "
                         "delta-skip best case (with --streams)")
    ap.add_argument("--collect", action="store_true",
                    help="keep every served frame's outputs on the host (with --streams; "
                         "for tests and checks)")
    ap.add_argument("--shard", default=None,
                    help="image mesh 'DxRxC' (data x row x col) or 'auto'; "
                         "default: the arch's sobel_shard")
    ap.add_argument("--simulate-loss-at", type=int, default=0, metavar="N",
                    help="before request N, drop half the devices and "
                         "reshard (sugar for the chaos plan entry 'loss@N')")
    ap.add_argument("--chaos", default=None, metavar="PLAN",
                    help="deterministic fault-injection plan (DSL in "
                         "repro_torch/runtime/chaos.py), e.g. "
                         "'loss@4;fail@step:1x2;slow@s1:40;corrupt@0:3=nan'; "
                         "the run prints a health ledger and exits non-zero "
                         "if any submitted frame goes unaccounted")
    args = ap.parse_args(argv)

    cfg = get_config(args.arch, smoke=args.smoke)
    if cfg.family != "image":
        for flag, on in (("--edges", args.edges), ("--shard", args.shard),
                         ("--streams", args.streams), ("--chaos", args.chaos)):
            if on:
                raise SystemExit(f"{flag} applies to image (detector) serving; arch "
                                 f"{cfg.name!r} is family {cfg.family!r}")
        if cfg.family in ("encdec", "vlm"):
            raise SystemExit(f"{cfg.family} serving needs frontend inputs; use examples/")
        return serve_lm(cfg.replace(dtype="float32"), args)
    if args.streams > 0:
        return serve_streams(cfg, args)
    return serve_image(cfg, args, devices=devices)


if __name__ == "__main__":
    main()
