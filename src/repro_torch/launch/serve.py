"""Serving launcher: ``python -m repro_torch.launch.serve --arch <id>``.

LM mode (``--arch llama3.2-1b``, the other dense configs and
``falcon-mamba-7b``): the port of ``repro.launch.serve.serve_lm``. Random weights from seed 0, drawn on the
device, in f32 (the reference's server forces ``dtype="float32"``); the
continuous-batching :class:`~repro_torch.serve.Engine` with ``--slots``
slots, ``--max-len`` positions and prompt buckets 8/16/32/64 serves
``--requests`` prompts of the reference's (``default_rng(0)``, lengths 2-23,
uniform token ids), ``--max-new`` tokens each, greedy. Prefill attention
runs kernel K4 on the card, an ssm model's prefill scan kernel K5; TF32
products are switched off. Prints tokens per second over the whole run,
the prefill and decode-step p50 (host clock, each ended by a device
synchronise) and K4's and K5's launches. The first prefill pays the
kernel's build when it is not built yet. An ssm model refuses those
prompts as the reference's server does: its engine takes only contexts of
a bucket's exact length, and the first prompt that is not raises
``ValueError`` with the reference's message.

Image mode: one request is one batch of ``--slots`` synthetic frames
(``data.synthetic.image_batch``) through :func:`repro_torch.api.edge_detect`
with the arch's ``EdgeConfig`` plus ``with_max``. One warm-up request runs
first (it also builds the CUDA kernels on first use); then every request's
host-to-device transfer and its compute are timed separately, each ended by
a device synchronise. Prints megapixels per second over the compute time
and the p50/p95 of both, as ``repro.launch.serve`` does. ``--edges`` serves
binary edge maps instead: NMS fused into K1, hysteresis linking after it,
and the edge density of the last request.

Streaming mode, ``--streams N``: N synthetic camera streams
(``data.synthetic.video_frame``, ``--motion`` px per frame) push
``--requests`` frames each at ``--fps`` through the
:class:`~repro_torch.serve.StreamEngine` (NMS and hysteresis always on,
per-tile delta-skip through K3; ``--decay`` > 0 turns on temporal
hysteresis). Prints per-stream compute and transfer p50/p99, the skip rate
and the engine's health ledger.

Runs on the CUDA device by default; ``--device cpu`` runs the plain
PyTorch version. There is no fallback between the two: the stream
engine retries a failing step (``serve/guard.py``) and then raises, and
its health line reports the retries. ``main returns what it printed as a dict.
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


def serve_image(cfg, args) -> dict:
    """Serve ``args.requests`` requests; returns the numbers it printed and
    the last request's :class:`~repro_torch.api.EdgeResult`."""
    from repro_torch.api import edge_detect
    from repro_torch.data.synthetic import image_batch
    from repro_torch.kernels.dispatch import resolve_backend, resolve_device

    device = resolve_device(args.device)
    overrides = dict(with_max=True)
    if args.edges:
        # Detector traffic: NMS fused into the kernel pass, hysteresis
        # linking after it; requests return binary edge maps.
        overrides.update(nms=True, hysteresis=True)
    edge_cfg = cfg.edge_config(**overrides).resolved()
    backend = resolve_backend(edge_cfg.backend, device)
    print(
        f"serving {cfg.name}: operator={edge_cfg.operator} "
        f"variant={edge_cfg.variant} directions={edge_cfg.directions} "
        f"backend={backend} {cfg.image_h}x{cfg.image_w} device={device}"
        f"{' mode=edges (NMS+hysteresis)' if args.edges else ''}"
    )

    def sync():
        if device.type == "cuda":
            torch.cuda.synchronize(device)

    def request(step):
        return torch.from_numpy(image_batch(cfg, batch=args.slots, step=step)["images"])

    edge_detect(request(0).to(device), edge_cfg, device=device)
    sync()

    lat_ms, xfer_ms = [], []
    px_total = 0
    out = None
    t_all = time.perf_counter()
    for req in range(args.requests):
        host = request(req)
        t_x = time.perf_counter()
        frames = host.to(device)
        sync()
        xfer_ms.append((time.perf_counter() - t_x) * 1e3)
        t0 = time.perf_counter()
        out = edge_detect(frames, edge_cfg, device=device)
        sync()
        lat_ms.append((time.perf_counter() - t0) * 1e3)
        px_total += frames.shape[0] * cfg.image_h * cfg.image_w
    wall = time.perf_counter() - t_all
    if not lat_ms:
        print(f"0 requests served in {wall:.2f}s (warm-up only; "
              "use --requests >= 1 for steady-state numbers)")
        return {"requests": 0, "result": None}
    stats = {
        "requests": args.requests,
        "slots": args.slots,
        "mps": px_total / 1e6 / (sum(lat_ms) / 1e3),
        "compute_p50_ms": _percentile(lat_ms, 50),
        "compute_p95_ms": _percentile(lat_ms, 95),
        "transfer_p50_ms": _percentile(xfer_ms, 50),
        "transfer_p95_ms": _percentile(xfer_ms, 95),
        "result": out,
    }
    tag = ""
    if args.edges:
        # The edge-pixel density of the last request: a blank camera or a
        # threshold misconfiguration shows up as 0.0 or ~1.0.
        stats["edge_density"] = float(out.edges.float().mean())
        tag = f"; edge density={stats['edge_density']:.3f}"
    print(
        f"{args.requests} requests x {args.slots} frames, {wall:.2f}s -> "
        f"{stats['mps']:.1f} MPS; compute p50={stats['compute_p50_ms']:.1f}ms "
        f"p95={stats['compute_p95_ms']:.1f}ms; transfer "
        f"p50={stats['transfer_p50_ms']:.1f}ms "
        f"p95={stats['transfer_p95_ms']:.1f}ms{tag}"
    )
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
    )

    def source(sid):
        def frame(i):
            if i >= args.requests:
                return None
            return video_frame(cfg, stream=sid, step=i, motion=args.motion)
        return frame

    engine = StreamEngine(edge_cfg, max_streams=args.slots, collect=args.collect,
                          device=device)
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


def main(argv: Optional[Sequence[str]] = None) -> dict:
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
    args = ap.parse_args(argv)

    try:
        cfg = get_config(args.arch, smoke=args.smoke)
    except NotImplementedError as e:
        raise SystemExit(str(e)) from e
    if cfg.family != "image":
        for flag, on in (("--edges", args.edges), ("--streams", args.streams)):
            if on:
                raise SystemExit(f"{flag} applies to image (detector) serving; arch "
                                 f"{cfg.name!r} is family {cfg.family!r}")
        return serve_lm(cfg.replace(dtype="float32"), args)
    if args.streams > 0:
        return serve_streams(cfg, args)
    return serve_image(cfg, args)


if __name__ == "__main__":
    main()
