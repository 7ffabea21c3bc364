"""Training loop with checkpoint/resume for the port's loadgen model.

Counterpart of ``tpumon/loadgen/train.py`` on one GPU.
``python -m tpumon_torch.loadgen.train --attention flash --metrics-port
9177`` runs the Llama-style model's SGD loop on synthetic data on the
card, saving checkpoints (``tpumon_torch.loadgen.checkpoint``) every
``--ckpt-every`` steps and resuming from the latest one on restart, and
serves the same ``tpumon_train_*`` Prometheus text as the reference, so
the unchanged monitor scrapes it through ``TPUMON_SERVING_TARGETS``.

Ported here: ``parallel="auto"`` on one device. Sequence parallelism
(``"sp"``/``"sp-ring"``) and the dp x tp mesh are multi-GPU work, the MoE
family and the workload self-report are not yet ported (ROADMAP queue 1
items 8 and 12), and ``train_induction`` comes with the slice that uses
it.
"""

from __future__ import annotations

import time
from dataclasses import dataclass
from typing import NamedTuple

import torch

from tpumon_torch import prng
from tpumon_torch.loadgen.checkpoint import restore_checkpoint, save_checkpoint
from tpumon_torch.loadgen.model import (
    ModelConfig,
    init_params,
    resolve_device,
    sgd_train_step,
)


@dataclass(frozen=True)
class TrainConfig:
    model: ModelConfig
    steps: int = 100
    batch: int = 8
    seq: int = 64
    lr: float = 1e-3
    ckpt_dir: str | None = None
    ckpt_every: int = 20
    seed: int = 0
    # "auto": one device. The reference's "sp" / "sp-ring" sequence
    # parallelism runs across devices and is not yet ported.
    parallel: str = "auto"

    def __post_init__(self) -> None:
        if self.parallel not in ("auto", "sp", "sp-ring"):
            raise ValueError(f"unknown parallel mode {self.parallel!r}")
        if self.parallel != "auto":
            raise NotImplementedError(
                f"parallel={self.parallel!r} is not yet ported (ROADMAP "
                "queue 1 item 12)")


def _tokens(k, cfg: TrainConfig, device) -> torch.Tensor:
    """int32 [batch, seq] tokens in [0, vocab) drawn as
    ``jax.random.randint`` draws them from key ``k``, on ``device``. The
    draw runs on the host; a CUDA copy goes through pinned memory without
    blocking, so it overlaps the card's queued work."""
    tokens = torch.from_numpy(prng.randint(k, (cfg.batch, cfg.seq), 0,
                                           cfg.model.vocab))
    device = torch.device(device)
    if device.type != "cuda":
        return tokens.to(device)
    return tokens.pin_memory().to(device, non_blocking=True)


def synthetic_batch(cfg: TrainConfig, step: int,
                    device: str | torch.device = "cpu") -> torch.Tensor:
    """Deterministic per-(seed, step) int32 token batch, so a resumed run
    continues the original's data order: the reference's tokens bit for
    bit, ``randint`` under ``fold_in(PRNGKey(seed ^ 0x5EED), step)``
    (``tpumon_torch.prng``)."""
    return _tokens(prng.fold_in(prng.key(cfg.seed ^ 0x5EED), step), cfg,
                   device)


# Dense peaks of NVIDIA cards from their data sheets, first match of the
# device name wins: (name contains, variant, bf16 TFLOP/s on tensor cores,
# f32 TFLOP/s on CUDA cores, memory TB/s, int8 TOP/s on tensor cores). The
# basis of MFU and of the burns' roofline guards; an unknown card reports
# no MFU unless an explicit peak is passed.
NVIDIA_PEAKS = (
    ("H200", "H200 SXM", 989.0, 67.0, 4.8, 1979.0),
    ("H100 PCIE", "H100 PCIe", 756.0, 51.0, 2.0, 1513.0),
    ("H100 NVL", "H100 NVL", 835.0, 60.0, 3.9, 1670.0),
    ("H100", "H100 SXM", 989.0, 67.0, 3.35, 1979.0),
)


class CardPeaks(NamedTuple):
    """A card's dense peaks, per second: bf16 and f32 FLOP/s, memory
    bytes/s, int8 OP/s."""

    variant: str
    bf16: float
    f32: float
    hbm: float
    int8: float


def card_peaks(kind: str) -> CardPeaks | None:
    """The peaks of a device name such as ``torch.cuda.get_device_name()``,
    or None if unknown."""
    up = kind.upper()
    for needle, variant, bf16, f32, tbps, int8 in NVIDIA_PEAKS:
        if needle in up:
            return CardPeaks(variant, bf16 * 1e12, f32 * 1e12, tbps * 1e12,
                             int8 * 1e12)
    return None


def detect_peak_flops() -> float | None:
    """Peak dense bf16 FLOP/s of the card the trainer runs on (device 0),
    or None on the CPU or an unknown card."""
    if not torch.cuda.is_available():
        return None
    peaks = card_peaks(torch.cuda.get_device_name(0))
    return peaks.bf16 if peaks else None


def flops_per_token(cfg: ModelConfig, seq: int) -> float:
    """Training FLOPs per token: the standard 6·N (fwd 2N + bwd 4N over
    all parameters) plus the attention term 12·L·s·d (score+value
    matmuls, fwd+bwd, across layers at sequence length s)."""
    # MoE family: FLOPs count ACTIVE parameters per token — the router
    # plus the ONE routed expert (top-1, in+out projections) — not the
    # full expert bank (standard MoE accounting).
    ffn = (cfg.d_model * cfg.n_experts + 2 * cfg.d_model * cfg.d_ff
           if cfg.n_experts else 3 * cfg.d_model * cfg.d_ff)
    n_params = (
        cfg.vocab * cfg.d_model * 2  # embed + untied lm_head
        + cfg.n_layers * (
            cfg.d_model * (cfg.n_heads + 2 * cfg.n_kv_heads)
            * cfg.head_dim  # qkv
            + cfg.n_heads * cfg.head_dim * cfg.d_model  # wo
            + ffn
            + 2 * cfg.d_model  # norms
        )
        + cfg.d_model  # final norm
    )
    return 6.0 * n_params + 12.0 * cfg.n_layers * seq * cfg.d_model


class TrainMetrics:
    """Live training telemetry, exposed as Prometheus text: step
    progress, loss, amortized step time, token throughput, goodput
    (productive step time over wall time: checkpoint saves and restore
    stalls are the rest) and MFU (achieved model FLOP/s over the card's
    peak). The reference's class, text for text. Updates are plain
    attribute writes from the train loop; the HTTP scrape thread only
    formats them.
    """

    def __init__(self, flops_per_token: float | None = None,
                 peak_flops: float | None = None) -> None:
        self.started = time.time()
        self.step = -1
        self.loss: float | None = None
        self.step_time_ema_s: float | None = None
        self.tokens_total = 0
        self.ckpt_step = -1
        self.productive_s = 0.0
        self.flops_per_token = flops_per_token
        self.peak_flops = peak_flops

    def observe_step(self, step: int, dt_s: float, batch_tokens: int) -> None:
        self.step = step
        self.tokens_total += batch_tokens
        self.productive_s += dt_s
        ema = self.step_time_ema_s
        self.step_time_ema_s = dt_s if ema is None else 0.9 * ema + 0.1 * dt_s

    @property
    def mfu_pct(self) -> float | None:
        """Cumulative MFU from totals: the loop only enqueues work on the
        card, so a single loop dt can be far from the device step time;
        totals amortize that away."""
        if not (self.flops_per_token and self.peak_flops
                and self.productive_s > 0):
            return None
        return 100.0 * (self.tokens_total * self.flops_per_token) / (
            self.productive_s * self.peak_flops)

    def metrics_text(self) -> str:
        wall = max(1e-9, time.time() - self.started)
        lines = [
            "# TYPE tpumon_train_tokens_total counter",
            f"tpumon_train_tokens_total {self.tokens_total}",
            "# TYPE tpumon_train_goodput_pct gauge",
            f"tpumon_train_goodput_pct {100.0 * min(1.0, self.productive_s / wall):.2f}",
        ]
        # -1 sentinels (no step yet / no checkpointing) are not data —
        # omit the gauges so the panel shows its "–" placeholder.
        if self.step >= 0:
            lines += ["# TYPE tpumon_train_step gauge",
                      f"tpumon_train_step {self.step}"]
        if self.ckpt_step >= 0:
            lines += ["# TYPE tpumon_train_checkpoint_step gauge",
                      f"tpumon_train_checkpoint_step {self.ckpt_step}"]
        if self.loss is not None:
            lines += ["# TYPE tpumon_train_loss gauge",
                      f"tpumon_train_loss {self.loss:.6f}"]
        if self.step_time_ema_s is not None:
            lines += ["# TYPE tpumon_train_step_time_seconds gauge",
                      f"tpumon_train_step_time_seconds {self.step_time_ema_s:.6f}"]
        if self.mfu_pct is not None:
            lines += ["# TYPE tpumon_train_mfu_pct gauge",
                      f"tpumon_train_mfu_pct {self.mfu_pct:.2f}"]
        return "\n".join(lines) + "\n"


def start_metrics_server(metrics: TrainMetrics, port: int = 0):
    """Serve ``metrics.metrics_text()`` on /metrics; returns (httpd, url)."""
    import threading
    from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

    class Handler(BaseHTTPRequestHandler):
        def do_GET(self):  # noqa: N802 (stdlib API name)
            if self.path.rstrip("/") not in ("", "/metrics"):
                self.send_response(404)
                self.end_headers()
                return
            body = metrics.metrics_text().encode()
            self.send_response(200)
            self.send_header("Content-Type", "text/plain; version=0.0.4")
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def log_message(self, *a):  # quiet
            pass

    httpd = ThreadingHTTPServer(("0.0.0.0", port), Handler)
    threading.Thread(target=httpd.serve_forever, daemon=True).start()
    return httpd, f"http://127.0.0.1:{httpd.server_port}/metrics"


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def fused_train_bench(cfg: TrainConfig, steps: int, device=None) -> dict:
    """Steady-state train throughput: one untimed step (kernel builds,
    allocator warm-up), then ``steps`` steps, timed from a synchronize to
    a synchronize. Each step draws its tokens as the reference's scanned
    loop does, ``randint`` under ``split(PRNGKey(2), steps)``; the
    reference fuses the loop into one jitted scan, eager PyTorch runs it
    as a Python loop.

    Returns {seconds, tokens_per_sec, mfu_pct (None off a known card),
    loss}.
    """
    device = resolve_device(device)
    gen = torch.Generator(device=device).manual_seed(cfg.seed)
    params = init_params(cfg.model, gen)

    def step(k):
        tokens = _tokens(k, cfg, device)
        return sgd_train_step(cfg.model, params, tokens, lr=cfg.lr)[1]

    step(prng.split(prng.key(1), 1)[0])
    _sync(device)
    t0 = time.perf_counter()
    for k in prng.split(prng.key(2), steps):
        loss = step(k)
    _sync(device)
    dt = time.perf_counter() - t0
    tokens = steps * cfg.batch * cfg.seq
    peak = detect_peak_flops() if device.type == "cuda" else None
    fpt = flops_per_token(cfg.model, cfg.seq)
    return {
        "seconds": dt,
        "tokens_per_sec": tokens / dt,
        "mfu_pct": 100.0 * tokens * fpt / (dt * peak) if peak else None,
        "loss": float(loss),
    }


def run_train(cfg: TrainConfig, device=None, log=lambda s: None,
              metrics: TrainMetrics | None = None) -> dict:
    """Run (or resume) the loop on one device (CUDA unless asked
    otherwise); returns {step, loss, resumed_from, tokens_per_sec, mesh,
    params}."""
    device = resolve_device(device)
    gen = torch.Generator(device=device).manual_seed(cfg.seed)
    params = init_params(cfg.model, gen)
    start = 0
    resumed_from = None
    if cfg.ckpt_dir:
        restored = restore_checkpoint(cfg.ckpt_dir, like=params, cfg=cfg.model)
        if restored is not None:
            params, saved_step = restored
            start = resumed_from = saved_step + 1
            log(f"resumed from step {saved_step}")
    return _train_loop(cfg, device, log, metrics, params, start, resumed_from)


def _train_loop(cfg, device, log, metrics, params, start,
                resumed_from) -> dict:
    loss = None  # stays None when resume lands at/past the final step
    t0 = time.perf_counter()
    tokens_seen = 0
    for step in range(start, cfg.steps):
        t_step = time.perf_counter()
        tokens = synthetic_batch(cfg, step, device)
        params, loss_t = sgd_train_step(cfg.model, params, tokens, lr=cfg.lr)
        tokens_seen += cfg.batch * cfg.seq
        if metrics is not None:
            # The loop only enqueues work on the card: loop dt amortizes
            # to the device step time once the queue is full, and the
            # loss syncs only on checkpoint steps below.
            metrics.observe_step(
                step, time.perf_counter() - t_step, cfg.batch * cfg.seq)
        if cfg.ckpt_dir and (
                (step + 1) % cfg.ckpt_every == 0 or step == cfg.steps - 1):
            save_checkpoint(cfg.ckpt_dir, params, step=step, cfg=cfg.model)
            if metrics is not None:
                metrics.ckpt_step = step
                metrics.loss = float(loss_t)
            log(f"step {step}: loss {float(loss_t):.4f} (checkpointed)")
        loss = loss_t
    if metrics is not None and loss is not None:
        metrics.loss = float(loss)
    _sync(device)
    dt = time.perf_counter() - t0
    return {
        "step": cfg.steps - 1,
        "loss": float(loss) if loss is not None else None,
        "resumed_from": resumed_from,
        "tokens_per_sec": round(tokens_seen / dt, 1) if dt > 0 else 0.0,
        "mesh": None,
        "params": params,
    }


def main(argv: list[str] | None = None) -> int:
    """``python -m tpumon_torch.loadgen.train`` — the loadgen trainer on
    the GPU, with the reference's flags. Multi-device modes and the MoE
    family exit with "not yet ported"."""
    import argparse

    ap = argparse.ArgumentParser(description=main.__doc__)
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=64)
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--ckpt-every", type=int, default=20)
    ap.add_argument(
        "--metrics-port", type=int, default=None,
        help="expose tpumon_train_* Prometheus metrics on this port "
        "(0 = ephemeral); add the printed URL to tpumon's serving_targets")
    ap.add_argument(
        "--peak-tflops", type=float, default=None,
        help="the card's peak dense bf16 TFLOP/s for MFU (default: from "
        "the device name; unknown cards omit MFU; 0 disables it)")
    ap.add_argument(
        "--remat", action="store_true",
        help="per-layer rematerialization (torch.utils.checkpoint): "
        "recompute each layer's activations in the backward pass")
    ap.add_argument(
        "--attention", choices=["naive", "chunked", "flash"],
        default="naive",
        help="'chunked' streams K/V blocks with an online softmax "
        "(O(T*block) attention memory); 'flash' runs the hand-written "
        "causal flash CUDA kernels, forward and backward")
    ap.add_argument("--attn-block", type=int, default=512,
                    help="K/V block rows for --attention chunked, block "
                    "grid for flash")
    ap.add_argument("--experts", type=int, default=0,
                    help="MoE model family (not yet ported; 0 = dense)")
    ap.add_argument("--parallel", choices=["auto", "sp", "sp-ring"],
                    default="auto",
                    help="'auto': one device; 'sp'/'sp-ring' sequence "
                    "parallelism is not yet ported")
    ap.add_argument("--no-report", action="store_true",
                    help="accepted for flag parity; the workload "
                    "self-report is not yet ported")
    ap.add_argument("--device", default="cuda",
                    help="torch device (default: cuda; raises when no GPU "
                    "is present)")
    args = ap.parse_args(argv)
    if args.experts:
        ap.error("--experts is not yet ported (ROADMAP queue 1 item 8)")
    if args.parallel != "auto":
        ap.error(f"--parallel {args.parallel} is not yet ported (ROADMAP "
                 "queue 1 item 12)")

    cfg = TrainConfig(
        model=ModelConfig(
            vocab=2048, d_model=256, n_layers=4, n_heads=8, n_kv_heads=4,
            d_ff=1024, max_seq=max(64, args.seq), remat=args.remat,
            attention=args.attention, attn_block_k=args.attn_block,
        ),
        steps=args.steps, batch=args.batch, seq=args.seq,
        ckpt_dir=args.ckpt_dir, ckpt_every=args.ckpt_every,
    )
    device = resolve_device(args.device)
    metrics = httpd = None
    if args.metrics_port is not None:
        if args.peak_tflops is None:
            peak = detect_peak_flops() if device.type == "cuda" else None
        elif args.peak_tflops > 0:
            peak = args.peak_tflops * 1e12
        else:
            peak = None  # explicit 0 disables MFU even on known cards
        metrics = TrainMetrics(
            flops_per_token=flops_per_token(cfg.model, cfg.seq),
            peak_flops=peak)
        httpd, url = start_metrics_server(metrics, port=args.metrics_port)
        print(f"train metrics at {url}", flush=True)
    try:
        out = run_train(cfg, device, log=print, metrics=metrics)
    finally:
        if httpd is not None:
            httpd.shutdown()
            httpd.server_close()
    out.pop("params")
    print(out)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
