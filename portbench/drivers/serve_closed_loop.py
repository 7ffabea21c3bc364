"""Closed-loop serving driver: each client sends its next request as soon
as its last one completes.

Set-up builds the kernels, draws the weights on the device from the seed
(in the compute dtype, as the configuration's family draws them), builds
the port's ``ServingEngine`` with them, and runs the mix's own traffic
until as many requests have completed as there are clients, so the
window starts with the loop turned over once (waiting for every client's
first request would wait for the longest output in the table, a minute
in a chat mix). The window then runs ``engine.step()`` with the clients'
submissions between steps, on one host thread, for the given seconds.
Per request it keeps the submission time, the engine's time to first
token, the completion time (the end of the step that completed it) and
the tokens.

With ``trace`` a slice in the middle of the window runs under the
profiler, with host spans around the engine's step, prefill chunk,
decode step and sampling calls, and counts of the work in it: each
prefill chunk's (start, length), and per step the context rows of every
decode token.
"""

from __future__ import annotations

import random
import time

import torch

from portbench import compare, families, program, trace
from portbench.loadmix import Mix

WARMUP_LIMIT_S = 600.0


class Bench:
    kind = "serve"

    def __init__(self, cfg: dict, mix: dict, seed: int, device):
        self.cfg, self.mix, self.seed = cfg, mix, seed
        self.device = torch.device(device)
        self.fam = families.of(cfg)
        self.sizes = self.fam.sizes(cfg)
        self.check_s = 0.0  # set-up time spent only on the check

    # -- set-up ---------------------------------------------------------
    def setup(self, mark=lambda name: None) -> None:
        from tpumon_torch.loadgen.serving import ServingEngine

        program.build_kernels(self.device)
        mark("build")
        serving = self.cfg.get("serving", {})
        model = self.fam.model_config(self.cfg, serving.get("model", {}))
        settings = {**serving.get("engine", {}), **self.mix.get("engine", {})}
        self.scfg = program.serve_config(model, settings)
        self.dtype = model.torch_dtype
        params = self.fam.make_params(self.sizes, self.seed, self.device,
                                      self.dtype)
        self.loads = Mix(self.mix, self.seed, model.vocab)
        self.engine = ServingEngine(self.scfg, params=params,
                                    seed=self.seed & 0x7FFFFFFF,
                                    max_queue=self.loads.clients,
                                    device=self.device)
        del params
        mark("engine")
        self.done: list[dict] = []   # finished requests, in order
        self.live: dict = {}         # client -> (record, Request)
        self.sent = [0] * self.loads.clients
        for c in range(self.loads.clients):
            self._submit(c)
        t0 = time.monotonic()
        while len(self.done) < self.loads.clients:  # a round's completions
            self._step()
            if time.monotonic() - t0 > WARMUP_LIMIT_S:
                raise RuntimeError("warm-up did not reach steady state")
        mark("warm-up")

    def _submit(self, c: int) -> None:
        k = self.sent[c]
        prompt, out = self.loads.request(c, k)
        req = self.engine.submit(prompt, max_new=out - 1)
        self.sent[c] = k + 1
        rec = {"client": c, "k": k, "prompt": prompt, "n": len(prompt),
               "out": out, "req": req, "t_done": None}
        self.live[c] = (rec, req)

    def _step(self) -> None:
        with trace.span("serve.step"):
            self.engine.step()
        now = time.monotonic()
        with trace.span("bench.clients"):
            for c, (rec, req) in list(self.live.items()):
                if req.done.is_set():
                    rec["t_done"] = now
                    self.done.append(rec)
                    self._submit(c)

    # -- window ---------------------------------------------------------
    def window(self, seconds: float, traced: bool) -> dict:
        start_len = {id(req): len(req.output) for _, req in self.live.values()}
        first_done = len(self.done)
        steps_ms = []
        sl = trace.Slice(self.device) if traced else None
        piece = trace.SLICE_S
        sl_from = (seconds - piece) / 2 if traced else None
        rec_work = None
        if sl is not None:
            sl.warm()
        t0 = time.monotonic()
        end = t0 + seconds
        now = t0
        while now < end or (rec_work is not None and not rec_work["closed"]):
            if sl is not None and rec_work is None and now - t0 >= sl_from:
                rec_work = self._start_slice(sl)
            in_slice = rec_work is not None and not rec_work["closed"]
            if in_slice:
                before = [(r, len(r.output)) for _, r in self.live.values()]
            a = time.monotonic()
            self._step()
            now = time.monotonic()
            if in_slice:
                rec_work["steps"].append([
                    (len(r.prompt), o, len(r.output)) for r, o in before
                    if len(r.output) > o])
                if now - rec_work["t0"] >= piece:
                    self._stop_slice(sl, rec_work)
            else:
                steps_ms.append((now - a) * 1e3)
        t1 = now
        recs = [rec for _, (rec, _) in sorted(self.live.items())]
        window_reqs = self.done[first_done:]
        tokens = sum(len(r["req"].output) - start_len.get(id(r["req"]), 0)
                     for r in window_reqs + recs)
        ttft = [r["req"].ttft_s * 1e3
                for r in self.done + recs
                if r["req"].first_tok_t is not None
                and t0 <= r["req"].first_tok_t <= t1]
        tpot = [(r["t_done"] - r["req"].first_tok_t)
                / (len(r["req"].output) - 1) * 1e3
                for r in window_reqs if len(r["req"].output) > 1]
        failed = sum(1 for r in window_reqs
                     if r["req"].status != "completed"
                     or len(r["req"].output) != r["out"])
        self.window_reqs = [r for r in window_reqs
                            if r["req"].status == "completed"]
        out = {"kind": self.kind, "window_s": t1 - t0, "tokens": tokens,
               "ttft_ms": ttft, "tpot_ms": tpot, "steps_ms": steps_ms,
               "attempted": len(window_reqs), "failed": failed,
               "family": families.name(self.cfg), "sizes": self.sizes,
               "elem": torch.tensor([], dtype=self.dtype).element_size(),
               "max_pages": -(-self.scfg.model.max_seq
                              // self.scfg.prefill_len)}
        if rec_work is not None:
            if not rec_work["closed"]:
                self._stop_slice(sl, rec_work)
            out["slice"] = sl.reduce()
            out["slice_work"] = rec_work
        return out

    def _start_slice(self, sl) -> dict:
        from tpumon_torch.loadgen import serving

        work = {"chunks": [], "steps": [], "closed": False,
                "prefill_seen": True}

        def chunk(args, kwargs):
            # paged_prefill(cfg, params, pool, tokens, length, page_id,
            # table_row, start)
            try:
                length = kwargs.get("length", args[4] if len(args) > 4
                                    else None)
                start = kwargs.get("start", args[7] if len(args) > 7
                                   else None)
                work["chunks"].append((int(start), int(length)))
            except (TypeError, ValueError, IndexError):
                work["prefill_seen"] = False

        self._wraps = [
            trace.wrapped(serving, "paged_prefill", "serve.prefill_chunk",
                          chunk),
            trace.wrapped(serving, "paged_decode_step", "serve.decode"),
            trace.wrapped(serving, "sample_tokens", "serve.sample"),
        ]
        found = [w.__enter__() for w in self._wraps]
        work["prefill_seen"] = work["prefill_seen"] and found[0]
        sl.start()
        work["t0"] = time.monotonic()
        return work

    def _stop_slice(self, sl, work: dict) -> None:
        sl.stop()
        for w in reversed(self._wraps):
            w.__exit__(None, None, None)
        work["closed"] = True

    # -- the check ------------------------------------------------------
    def release(self) -> None:
        del self.engine
        if self.device.type == "cuda":
            torch.cuda.empty_cache()

    def sample(self) -> list[dict]:
        """The requests compared: the longest finished in the window and
        others drawn from the seed, ``check_requests`` in all."""
        pool = sorted(self.window_reqs, key=lambda r: (-(r["n"] + r["out"]),
                                                       r["client"], r["k"]))
        if not pool:
            return []
        want = int(self.mix.get("check_requests", 4))
        rest = pool[1:]
        random.Random(self.seed).shuffle(rest)
        return [{"prompt": r["prompt"], "output": list(r["req"].output)}
                for r in [pool[0]] + rest[: want - 1]]

    def check(self, control: bool = False) -> dict:
        reqs = self.sample()
        if not reqs:
            return {"logit_gap": float("inf")}
        return compare.served_gaps(self.sizes, self.cfg, self.seed,
                                   self.dtype, self.device, reqs,
                                   control=control)
