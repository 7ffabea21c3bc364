"""Training-steps driver: the port's ``sgd_train_step`` over seeded
batches.

Set-up builds the kernels and draws the float32 master weights on the
device from the seed, as the configuration's family draws them, then
drives that one parameter tree through the window's own step and feed
for its first three steps, which also warm every shape up. It reads each
step's loss, each leaf's first gradient (its change after one step over
the learning rate) and each leaf's change after three (the initial
values drawn again from the seed, one kind at a time); those readings
are the check's and are not counted as set-up. The window continues the
same tree from step 3 and ends in a ``synchronize``. Every step's tokens
are drawn on the device from the seed and the step's index, so all rows
differ.

With ``trace`` a slice in the middle of the window runs under the
profiler, with host spans around each step and its feed.
"""

from __future__ import annotations

import time

import torch

from portbench import compare, families, models, program, trace

CHECK_STEPS = 3


class Bench:
    kind = "train"

    def __init__(self, cfg: dict, mix: dict, seed: int, device):
        self.cfg, self.mix, self.seed = cfg, mix, seed
        self.device = torch.device(device)
        self.fam = families.of(cfg)
        self.sizes = self.fam.sizes(cfg)
        self.batch, self.seq = int(mix["batch"]), int(mix["seq"])
        self.lr = float(cfg.get("training", {}).get("lr", 1e-3))
        self.check_s = 0.0

    def _sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize()

    def feed(self, i: int) -> torch.Tensor:
        with trace.span("train.feed"):
            return models.token_batch(self.seed, i, self.batch, self.seq + 1,
                                      self.sizes.vocab, self.device)

    def step(self, i: int) -> torch.Tensor:
        from tpumon_torch.loadgen import model as pmodel

        tokens = self.feed(i)
        with trace.span("train.step"):
            return pmodel.sgd_train_step(self.model, self.params, tokens,
                                         lr=self.lr)[1]

    def _norms_from_start(self, scale: float) -> dict:
        named = dict(self.fam.reference.leaves(self.params))
        return {n: float((named[n] - p0).norm()) / scale
                for n, p0 in self.fam.initial_leaves(
                    self.sizes, self.seed, self.device, torch.float32)}

    def setup(self, mark=lambda name: None) -> None:
        program.build_kernels(self.device)
        mark("build")
        train = self.cfg.get("training", {})
        self.model = self.fam.model_config(
            self.cfg, {"max_seq": self.seq, **train.get("model", {})})
        self.params = self.fam.make_params(self.sizes, self.seed,
                                           self.device, torch.float32)
        self._sync()
        mark("weights")
        self.readings = {"loss": []}
        for i in range(CHECK_STEPS):
            loss = self.step(i)
            self._sync()  # the step's device time is set-up, not the check's
            t = time.monotonic()
            self.readings["loss"].append(float(loss))
            if i == 0:
                self.readings["grad_norms"] = self._norms_from_start(self.lr)
            if i == CHECK_STEPS - 1:
                self.readings["change_norms"] = self._norms_from_start(1.0)
            self.check_s += time.monotonic() - t
            mark(f"step{i}")
        self._sync()

    def window(self, seconds: float, traced: bool) -> dict:
        sl = trace.Slice(self.device) if traced else None
        piece = trace.SLICE_S
        sl_from = (seconds - piece) / 2
        sl_t0 = None
        losses = []
        i = CHECK_STEPS
        if sl is not None:
            sl.warm()
        self._sync()
        t0 = time.monotonic()
        while True:
            now = time.monotonic()
            if sl is not None and sl_t0 is None and now - t0 >= sl_from:
                sl.start()
                sl_t0 = now
            losses.append(self.step(i))
            i += 1
            now = time.monotonic()
            if sl_t0 is not None and sl.events is None and (
                    now - sl_t0 >= piece):
                sl.stop()
            if now - t0 >= seconds and (sl is None or sl.events is not None):
                break
        self._sync()
        t1 = time.monotonic()
        steps = i - CHECK_STEPS
        finite = torch.stack(losses).isfinite()
        out = {"kind": self.kind, "window_s": t1 - t0, "steps": steps,
               "tokens": steps * self.batch * self.seq,
               "attempted": steps, "failed": int((~finite).sum()),
               "family": families.name(self.cfg), "sizes": self.sizes,
               "seq": self.seq, "batch": self.batch,
               "elem": torch.tensor([], dtype=self.model.torch_dtype
                                    ).element_size()}
        if sl is not None:
            out["slice"] = sl.reduce()
        return out

    def release(self) -> None:
        del self.params
        if self.device.type == "cuda":
            torch.cuda.empty_cache()

    def batches(self) -> list:
        return [models.token_batch(self.seed, i, self.batch, self.seq + 1,
                                   self.sizes.vocab, self.device)
                for i in range(CHECK_STEPS)]

    def check(self) -> dict:
        """The numbers compared: the program's readings against the float32
        reference's own steps."""
        return self.against_reference([{}])[0]

    def against_reference(self, variants: list) -> list:
        """The numbers of each variant against one run of the reference:
        ``{}`` is the program's readings; ``{"prec": "fp8"}`` or
        ``{"half_batch": True}`` puts the reference, computed so, in the
        program's place."""
        args = (self.sizes, self.cfg, self.seed, self.batches(), self.lr,
                self.device)
        ref = compare.reference_steps(*args)
        return [compare.train_numbers(
            compare.reference_steps(*args, **v) if v else self.readings, ref)
            for v in variants]
