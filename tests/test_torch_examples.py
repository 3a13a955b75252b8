"""The twins of ``examples/*`` (``examples_torch/``) on the CPU at their
smallest settings: every number each prints that is not a time equals the
reference's, computed here through the reference's modules (edges on
``backend="xla"``; the reference's ``examples/quickstart.py`` itself calls
the ``pallas-interpret`` lane and is not run). Floats are compared as
printed; the one exception is ``train_lm``'s bf16 loss, which two libraries
round at other places: it is held within ``TOL_LOSS_BF16``, the bound that
``test_torch_lm_model.py`` holds bf16 losses to. A missing card raises
under the default ``--device cuda``."""
import importlib.util
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.api import EdgeConfig as RefEdgeConfig
from repro.api import edge_detect as ref_edge_detect
from repro.configs import get_config as ref_get_config
from repro.core import SobelParams as RefSobelParams
from repro.core import list_operators as ref_list_operators
from repro.core import ssim as ref_ssim
from repro.data.synthetic import image_batch as ref_image_batch
from repro_torch.configs import get_config
from repro_torch.models import Model

ROOT = Path(__file__).resolve().parents[1]
TOL_LOSS_BF16 = 2e-2


def _twin(name):
    spec = importlib.util.spec_from_file_location(f"twin_{name}",
                                                  ROOT / "examples_torch" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _lines(capsys):
    return capsys.readouterr().out.splitlines()


@pytest.mark.parametrize("name", ["quickstart", "edge_service", "serve_lm", "long_context",
                                  "train_lm"])
def test_the_twin_raises_without_a_card_by_default(name, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        _twin(name).main([])


def test_quickstart_prints_the_references_numbers(capsys, monkeypatch):
    # The registries hold what other test modules registered in this
    # process (the card tests' "sep9" in the port's, at import): both loop
    # over the operators the two share.
    import repro_torch.core.filters as TF

    shared = tuple(sorted(set(ref_list_operators()) & set(TF.list_operators())))
    monkeypatch.setattr(TF, "list_operators", lambda: shared)
    _twin("quickstart").main(["--device", "cpu"])
    got = _lines(capsys)
    rcfg = ref_get_config("sobel-hd", smoke=True).replace(image_h=256, image_w=256)
    images = jnp.asarray(ref_image_batch(rcfg, batch=2)["images"])

    def run(**kw):
        return ref_edge_detect(images, RefEdgeConfig(backend="xla", **kw))

    want = [f"input batch: {images.shape} {images.dtype}"]
    res = run(operator="sobel5")
    want.append(f"edges: {res.magnitude.shape}, layout={res.layout}, "
                f"max={float(res.magnitude.max()):.1f}")
    rich = run(with_components=True, with_orientation=True, with_max=True)
    want.append(f"components: {rich.components.shape}, "
                f"orientation in [{float(rich.orientation.min()):.2f}, "
                f"{float(rich.orientation.max()):.2f}] rad, peaks={np.asarray(rich.peak)}")
    for op in shared:
        out = run(operator=op, normalize=False)
        want.append(f"operator {op:10s}: resolved variant={out.config.variant}, "
                    f"directions={out.config.directions}, "
                    f"mean={float(out.magnitude.mean()):.1f}")
    ref = run(variant="direct", normalize=False)
    for variant in ("separable", "v1", "v2"):
        out = run(variant=variant, normalize=False)
        s = float(jnp.mean(ref_ssim(out.magnitude, ref.magnitude)))
        want.append(f"variant {variant:10s}: SSIM vs naive = {s:.6f}")
    kern = run(normalize=False, block_h=64)
    want.append("kernel max |err| vs torch lane: 0.00e+00 (bit-equal)")
    want.append(f"kernel max |err| vs naive reference: "
                f"{float(jnp.max(jnp.abs(kern.magnitude - ref.magnitude))):.2e}")
    custom = run(params=RefSobelParams(a=1, b=3, m=8, n=4))
    want.append(f"custom-weight edges: max={float(custom.magnitude.max()):.1f}")
    assert got == want


def test_edge_service_matches_the_reference_sharded_fn(capsys):
    from repro.core.pipeline import make_sharded_edge_fn as ref_make
    from repro.runtime.elastic import make_mesh as ref_make_mesh

    out = _twin("edge_service").main(["--batch", "2", "--size", "64", "--iters", "1",
                                      "--operator", "scharr3", "--device", "cpu"])
    got = _lines(capsys)
    mesh = ref_make_mesh(jax.devices()[:1], model_parallel=1)
    assert got[0] == f"mesh: {dict(mesh.shape)} over 1 device(s)"
    rcfg = ref_get_config("sobel-hd").replace(image_h=64, image_w=64)
    imgs = jnp.asarray(ref_image_batch(rcfg, 2)["images"])
    want = np.asarray(ref_make(mesh, RefEdgeConfig(operator="scharr3", normalize=False,
                                                   backend="xla"))(imgs))
    assert got[1].startswith(f"edges {want.shape} [scharr3]: ") and got[1].endswith(
        " MPS (paper Table 2 metric)")
    assert np.array_equal(out.numpy(), want)


def test_serve_lm_decodes_the_references_tokens(capsys):
    from repro.models import Model as RefModel
    from repro.serve import Engine as RefEngine
    from repro.serve import Request as RefRequest

    done = _twin("serve_lm").main(["--device", "cpu"])
    got = _lines(capsys)
    rcfg = ref_get_config("llama3.2-1b", smoke=True).replace(dtype="float32")
    params = Model(get_config("llama3.2-1b", smoke=True).replace(dtype="float32")).init(
        0, device="cpu")
    rparams = jax.tree.map(lambda t: jnp.asarray(t.numpy()), params)
    engine = RefEngine(rcfg, rparams, max_batch=4, max_len=128, prompt_buckets=(8, 16, 32))
    rng = np.random.default_rng(0)
    for uid in range(10):
        plen = int(rng.integers(2, 12))
        engine.submit(RefRequest(uid=uid, prompt=rng.integers(0, rcfg.vocab_size, plen).tolist(),
                                 max_new_tokens=12))
    ref = sorted(engine.run(), key=lambda r: r.uid)
    assert got[0] == f"serving {rcfg.name} ({RefModel(rcfg).param_count():,} params), 4 slots"
    assert got[1].startswith(f"completed {len(ref)} requests, "
                             f"{sum(len(r.output) for r in ref)} tokens in ")
    assert got[2:] == [f"  req{r.uid}: {r.output}" for r in ref[:3]]
    assert [r.output for r in sorted(done, key=lambda r: r.uid)] == [r.output for r in ref]


def test_long_context_state_is_the_references(capsys):
    from repro.models import Model as RefModel

    out = _twin("long_context").main(["--tokens", "8", "--device", "cpu"])
    got = _lines(capsys)
    rcfg = ref_get_config("falcon-mamba-7b", smoke=True).replace(dtype="float32")
    rcache = RefModel(rcfg).init_cache(1, 8, dtype=jnp.float32)
    state = sum(int(np.prod(leaf.shape)) * leaf.dtype.itemsize
                for leaf in jax.tree.leaves(rcache))
    assert got[0] == (f"{rcfg.name}: {RefModel(rcfg).param_count():,} params, "
                      f"attention-free (mamba-1)")
    assert got[1] == f"recurrent state: {state/1024:.1f} KB — independent of context length"
    assert out["state_bytes"] == state
    assert [ln.split(":")[0] for ln in got[2:5]] == [f"  position {p:6d}" for p in (2, 4, 8)]
    assert torch.isfinite(out["logits"]).all()


def test_train_lm_first_loss_is_the_references(capsys, tmp_path):
    from repro.data import DataLoader as RefLoader
    from repro.models import Model as RefModel

    hist, trainer = _twin("train_lm").main(["--preset", "tiny", "--steps", "1", "--device",
                                            "cpu", "--ckpt", str(tmp_path)])
    got = [ln for ln in _lines(capsys) if not ln.startswith("step ")]
    rcfg = ref_get_config("llama3.2-1b", smoke=True)
    assert got[0] == f"model: {rcfg.name}  params={RefModel(rcfg).param_count():,}"
    cfg = get_config("llama3.2-1b", smoke=True)
    assert trainer.cfg.remat and trainer.cfg.remat_policy == "dots"
    rparams = jax.tree.map(lambda t: jnp.asarray(t.numpy()), Model(cfg).init(0, device="cpu"))
    loader = RefLoader(rcfg, 8, 64, seed=0)
    batch = next(iter(loader))
    loader.close()
    want, _ = RefModel(rcfg).loss_fn(rparams, batch)
    final, start = (float(v) for v in got[1].removeprefix("final loss: ").removesuffix(")")
                    .split(" (start "))
    assert final == start == round(hist["loss"][0], 4)
    assert abs(hist["loss"][0] - float(want)) <= TOL_LOSS_BF16
    assert got[2].startswith("step-time median: ")
