"""The port's checkpoint/resume, mirroring tests/test_train.py.

A resumed run equals an uninterrupted one (the batches are deterministic
per step), a completed run resumes to a no-op, a mismatched architecture
cold-starts, and the port's serving engine serves what the port's
trainer saved, also after training over a mesh or an sp mesh of
``[cpu] * n`` (the checkpoint holds the full tree, so it moves between
layouts). The on-disk layout (step directories, meta.json with the
reference's ModelConfig fields) is the reference's. Everything runs on
the CPU, so resumed params equal uninterrupted ones exactly.
"""

import dataclasses
import json
import os

import pytest

torch = pytest.importorskip("torch")

import tests.torch_parity  # noqa: E402,F401  (one intra-op thread, see there)
from tpumon.loadgen.model import ModelConfig as JaxModelConfig  # noqa: E402
from tpumon_torch.loadgen import checkpoint  # noqa: E402
from tpumon_torch.loadgen.model import (  # noqa: E402
    Mesh,
    ModelConfig,
    param_leaves,
)
from tpumon_torch.loadgen.serving import ServeConfig, ServingEngine  # noqa: E402
from tpumon_torch.loadgen.train import TrainConfig, run_train  # noqa: E402

# tests/test_train.py's MODEL, in f32 so the CPU run is exact.
SMALL = dict(vocab=64, d_model=32, n_layers=1, n_heads=4, n_kv_heads=2,
             d_ff=64, max_seq=32, compute_dtype="float32")
MODEL = ModelConfig(**SMALL)


def cfg(**kw):
    base = dict(model=MODEL, steps=6, batch=4, seq=16, ckpt_every=3)
    base.update(kw)
    return TrainConfig(**base)


def same_params(a, b) -> bool:
    return all(torch.equal(x, y)
               for x, y in zip(param_leaves(a), param_leaves(b)))


def test_resume_matches_uninterrupted_run(tmp_path):
    full = run_train(cfg(), "cpu")  # no checkpointing: ground truth
    d = str(tmp_path)
    first = run_train(cfg(steps=3, ckpt_dir=d), "cpu")  # "killed" at 3
    assert first["resumed_from"] is None
    second = run_train(cfg(ckpt_dir=d), "cpu")  # same command, rerun
    assert second["resumed_from"] == 3 and second["step"] == 5
    assert same_params(full["params"], second["params"])
    assert full["loss"] == second["loss"]


def test_completed_run_resumes_to_noop(tmp_path):
    d = str(tmp_path)
    done = run_train(cfg(ckpt_dir=d), "cpu")
    again = run_train(cfg(ckpt_dir=d), "cpu")
    assert again["resumed_from"] == 6  # past the last step: no step runs
    assert again["loss"] is None
    assert same_params(done["params"], again["params"])


def test_layout_is_the_references(tmp_path):
    """step_%08d directories and a meta.json whose model_config carries
    the reference's fields, so saved_model_config reads either's meta."""
    d = str(tmp_path)
    run_train(cfg(steps=2, ckpt_dir=d, ckpt_every=1), "cpu")
    assert sorted(os.listdir(d)) == ["meta.json", "step_00000000",
                                     "step_00000001"]
    with open(os.path.join(d, "meta.json")) as f:
        meta = json.load(f)
    assert meta["latest_step"] == 1
    assert meta["model_config"] == dataclasses.asdict(JaxModelConfig(**SMALL))
    assert checkpoint.latest_step(d) == 1
    assert checkpoint.saved_model_config(d) == MODEL


def test_schedule_fields_do_not_invalidate_a_resume(tmp_path):
    d = str(tmp_path)
    run_train(cfg(steps=3, ckpt_dir=d), "cpu")
    flash = dataclasses.replace(MODEL, attention="flash", remat=True,
                                attn_block_k=128)
    out = run_train(cfg(model=flash, steps=4, ckpt_dir=d), "cpu")
    assert out["resumed_from"] == 3


def test_mismatched_architecture_cold_starts(tmp_path):
    d = str(tmp_path)
    run_train(cfg(steps=2, ckpt_dir=d), "cpu")
    other = dataclasses.replace(MODEL, n_layers=2)
    engine = ServingEngine(cfg=ServeConfig(model=other, slots=2,
                                           prefill_len=8, kv_layout="paged",
                                           paged_attn="kernel"),
                           ckpt_dir=d, device="cpu")
    assert engine.ckpt_step is None  # cold init, no crash
    assert run_train(cfg(model=other, steps=1),
                     "cpu")["resumed_from"] is None
    assert checkpoint.restore_checkpoint(d, like=engine.params) is None
    # A damaged file is no checkpoint either.
    small = ServingEngine(cfg=ServeConfig(model=MODEL, slots=2,
                                          prefill_len=8, kv_layout="paged",
                                          paged_attn="kernel"), device="cpu")
    with open(os.path.join(d, "step_00000001", "params.pt"), "wb") as f:
        f.write(b"not a checkpoint")
    assert checkpoint.restore_checkpoint(d, like=small.params) is None


def test_serving_engine_serves_trained_checkpoint(tmp_path):
    d = str(tmp_path)
    trained = run_train(cfg(ckpt_dir=d), "cpu")
    engine = ServingEngine(cfg=ServeConfig(model=MODEL, slots=2,
                                           prefill_len=8, kv_layout="paged",
                                           paged_attn="kernel"),
                           ckpt_dir=d, device="cpu")
    assert engine.ckpt_step == 5
    assert same_params(trained["params"], engine.params)
    r = engine.submit([1, 2, 3], max_new=2)
    engine.drain()
    assert r.status == "completed" and len(r.output) == 3


CPU = torch.device("cpu")
# tests/test_train.py's dp 2 x tp 2 mesh, the default mesh over 4 devices
# (tp 4), and the two sp schedules over 2, as run_train's keywords. The sp
# layouts train on seq 17 (seq - 1 divides by 2n).
LAYOUTS = {
    "dp2_tp2": lambda: dict(mesh=Mesh([[CPU] * 2] * 2, ("data", "model"))),
    "auto_4": lambda: dict(devices=[CPU] * 4),
    "sp": lambda: dict(devices=[CPU] * 2),
    "sp-ring": lambda: dict(devices=[CPU] * 2),
}


def layout_cfg(layout, **kw):
    if layout.startswith("sp"):
        kw = dict(dict(seq=17, parallel=layout), **kw)
    return cfg(**kw)


@pytest.mark.parametrize("layout", list(LAYOUTS))
def test_resume_over_a_mesh_matches_uninterrupted_run(tmp_path, layout):
    """tests/test_train.py::test_resume_matches_uninterrupted_run over a
    mesh: the checkpoint holds the full tree (the one-device shapes), and
    the resumed run lands on the uninterrupted run's params and loss."""
    full = run_train(layout_cfg(layout), **LAYOUTS[layout]())
    d = str(tmp_path)
    first = run_train(layout_cfg(layout, steps=3, ckpt_dir=d),
                      **LAYOUTS[layout]())
    assert first["resumed_from"] is None
    saved = torch.load(os.path.join(d, "step_00000002", "params.pt"))
    assert [t.shape for t in param_leaves(saved)] == [
        t.shape for t in param_leaves(full["params"])]
    second = run_train(layout_cfg(layout, ckpt_dir=d), **LAYOUTS[layout]())
    assert second["resumed_from"] == 3 and second["step"] == 5
    assert same_params(full["params"], second["params"])
    assert full["loss"] == second["loss"]


def test_checkpoint_moves_between_layouts(tmp_path):
    """A run saved over a dp 2 x tp 2 mesh resumes on one device, and one
    saved on one device resumes over an sp mesh: each lands on the
    uninterrupted one-device run (the mesh's sums reassociate, so within
    f32 rounding)."""
    full = run_train(cfg(seq=17), "cpu")
    for first, second in ((LAYOUTS["dp2_tp2"](), dict(device="cpu")),
                          (dict(device="cpu"), LAYOUTS["sp"]())):
        d = str(tmp_path / str(len(os.listdir(tmp_path))))
        run_train(cfg(seq=17, steps=3, ckpt_dir=d), **first)
        par = "sp" if "devices" in second else "auto"
        out = run_train(cfg(seq=17, ckpt_dir=d, parallel=par), **second)
        assert out["resumed_from"] == 3
        assert abs(out["loss"] - full["loss"]) <= 1e-5 * full["loss"]
        for a, b in zip(param_leaves(full["params"]),
                        param_leaves(out["params"])):
            torch.testing.assert_close(b, a, rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("layout", ["dp2_tp2", "sp"])
def test_serving_engine_serves_mesh_trained_checkpoint(tmp_path, layout):
    """tests/test_train.py::test_serving_engine_serves_trained_checkpoint
    after training over a mesh: the engine loads the saved step and
    serves the trained weights."""
    d = str(tmp_path)
    trained = run_train(layout_cfg(layout, ckpt_dir=d), **LAYOUTS[layout]())
    engine = ServingEngine(cfg=ServeConfig(model=MODEL, slots=2,
                                           prefill_len=8), ckpt_dir=d,
                           device="cpu")
    assert engine.ckpt_step == 5
    assert same_params(trained["params"], engine.params)
    r = engine.submit([1, 2, 3], max_new=2)
    engine.drain()
    assert r.status == "completed" and len(r.output) == 3


def test_serving_engine_adopts_checkpoint_config(tmp_path):
    """No explicit ServeConfig: the engine takes the architecture from
    the checkpoint's meta, so the trained weights load."""
    d = str(tmp_path)
    run_train(cfg(steps=2, ckpt_dir=d), "cpu")
    engine = ServingEngine(ckpt_dir=d, device="cpu")
    assert engine.cfg.model == MODEL
    assert engine.ckpt_step == 1
