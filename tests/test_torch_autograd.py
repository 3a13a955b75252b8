"""K4 and K5 under autograd, on the CPU with a stand-in ``_launch`` (the
kernel's plain version, counted, returning a tensor with no ``grad_fn`` as
the kernel's ``ctypes``-written output has none): the bare
``backend="cuda"`` calls refuse to cut the graph, :class:`K4Attention` and
:class:`K5Scan` give the plain version's gradients and launch once a
forward, and every family's loss trains through them on the card lane
(``models.attention``/``models.ssm`` told that the lane is ``cuda``) with
the plain lane's gradients."""
import numpy as np
import pytest
import torch

from repro_torch.configs import get_config
from repro_torch.kernels import flash_attention as FA
from repro_torch.kernels import selective_scan as SS
from repro_torch.models import Model
from repro_torch.models import attention as A
from repro_torch.models import remat
from repro_torch.models import ssm as S
from repro_torch.tree import leaves, leaves_with_path, unflatten


@pytest.fixture
def stand_in(monkeypatch):
    """Both kernels' ``_launch`` replaced by counting plain versions."""
    def k4(q, k, v, causal):
        FA.flash_attention.launches += 1
        with torch.no_grad():
            return FA.flash_attention_plain(q, k, v, causal=causal)

    def k5(x, dt, b_mat, c_mat, a, **kw):
        SS.selective_scan.launches += 1
        with torch.no_grad():
            return SS.selective_scan_plain(x, dt, b_mat, c_mat, a, **kw)

    monkeypatch.setattr(FA, "_launch", k4)
    monkeypatch.setattr(SS, "_launch", k5)


def _leaf(rng, shape, grad=True):
    return torch.from_numpy(rng.normal(0, 1, shape).astype(np.float32)).requires_grad_(grad)


@pytest.mark.parametrize("causal,shape", [(True, (2, 3, 7, 7, 8)), (False, (1, 2, 5, 9, 16))])
def test_k4_function_gives_the_plain_gradients(stand_in, causal, shape):
    b, h, s, t, d = shape
    rng = np.random.default_rng(0)
    q, k, v = _leaf(rng, (b, h, s, d)), _leaf(rng, (b, h, t, d)), _leaf(rng, (b, h, t, d))
    go = torch.from_numpy(rng.normal(0, 1, (b, h, s, d)).astype(np.float32))
    before = FA.flash_attention.launches
    out = FA.k4_attention(q, k, v, causal=causal, block_q=s, block_kv=t)
    assert out.grad_fn is not None and FA.flash_attention.launches == before + 1
    got = torch.autograd.grad(out, (q, k, v), go)
    assert FA.flash_attention.launches == before + 1          # the backward launches nothing
    plain = FA.flash_attention_plain(q, k, v, causal=causal)
    want = torch.autograd.grad(plain, (q, k, v), go)
    assert torch.equal(out, plain)
    for g, w in zip(got, want):
        assert torch.equal(g, w)              # the same function recomputed: the same bits
    kq = torch.autograd.grad(FA.k4_attention(q.detach(), k, v, causal=causal, block_q=s,
                                             block_kv=t), k, go)[0]
    assert torch.equal(kq, want[1])           # inputs that need no grad get none


def test_k4_function_keeps_the_reference_shape_rule(stand_in):
    q = torch.zeros(1, 1, 6, 8)
    with pytest.raises(ValueError, match="must divide"):
        FA.k4_attention(q, q, q, block_q=4, block_kv=6)


def test_bare_cuda_calls_refuse_to_cut_the_graph(stand_in, monkeypatch):
    """The fault the Functions repair: ``flash_attention``/``selective_scan``
    on the kernel return a tensor with no ``grad_fn``, so under autograd
    they raise; with no grad needed (``no_grad``, or inputs that need none)
    they launch."""
    monkeypatch.setattr(FA, "resolve_backend", lambda backend, device: "cuda")
    monkeypatch.setattr(SS, "resolve_backend", lambda backend, device: "cuda")
    rng = np.random.default_rng(1)
    q = _leaf(rng, (1, 2, 4, 8))
    with pytest.raises(RuntimeError, match="k4_attention"):
        FA.flash_attention(q, q, q, backend="cuda")
    with torch.no_grad():
        assert FA.flash_attention(q, q, q, backend="cuda").grad_fn is None
    FA.flash_attention(q.detach(), q.detach(), q.detach(), backend="cuda")
    x, dt = _leaf(rng, (1, 6, 4)), _leaf(rng, (1, 6, 4), grad=False).abs()
    bm, cm, a = _leaf(rng, (1, 6, 3), False), _leaf(rng, (1, 6, 3), False), -_leaf(
        rng, (4, 3), False).abs()
    with pytest.raises(RuntimeError, match="k5_scan"):
        SS.selective_scan(x, dt, bm, cm, a, backend="cuda")
    with torch.no_grad():
        SS.selective_scan(x, dt, bm, cm, a, backend="cuda")


def test_k5_function_gives_the_plain_gradients(stand_in):
    """Gradients of x, dt, B, C and A through both outputs (y and the final
    state), the same bits as the plain scan's autograd."""
    rng = np.random.default_rng(2)
    bsz, l, di, n = 2, 9, 5, 4
    x, dt = _leaf(rng, (bsz, l, di)), _leaf(rng, (bsz, l, di), grad=False).abs().requires_grad_()
    bm, cm = _leaf(rng, (bsz, l, n)), _leaf(rng, (bsz, l, n))
    a = -_leaf(rng, (di, n), grad=False).abs().requires_grad_()
    gy = torch.from_numpy(rng.normal(0, 1, (bsz, l, di)).astype(np.float32))
    gh = torch.from_numpy(rng.normal(0, 1, (bsz, di, n)).astype(np.float32))
    wrt = (x, dt, bm, cm, a)
    before = SS.selective_scan.launches
    y, h = SS.k5_scan(x, dt, bm, cm, a, chunk=l, block_d=di)
    assert y.grad_fn is not None and SS.selective_scan.launches == before + 1
    got = torch.autograd.grad((y, h), wrt, (gy, gh))
    assert SS.selective_scan.launches == before + 1
    yp, hp = SS.selective_scan_plain(x, dt, bm, cm, a)
    want = torch.autograd.grad((yp, hp), wrt, (gy, gh))
    assert torch.equal(y, yp) and torch.equal(h, hp)
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    (gy_only,) = torch.autograd.grad(SS.k5_scan(x, dt, bm, cm, a, chunk=l, block_d=di)[0].sum(),
                                     (x,))
    (want_y,) = torch.autograd.grad(SS.selective_scan_plain(x, dt, bm, cm, a)[0].sum(), (x,))
    assert torch.equal(gy_only, want_y)       # an unused h_last adds nothing


# Every family whose forward runs a kernel on the card: GQA (llama), MoE,
# MLA (v padded), Mamba-1 (K5), the hybrid's shared block, whisper's
# encoder, decoder and cross-attention, pixtral's patches.
ARCHS = ("llama3.2-1b", "qwen3-moe-30b-a3b", "minicpm3-4b", "falcon-mamba-7b", "zamba2-2.7b",
         "whisper-large-v3", "pixtral-12b")
# The card lane's attention is flash_attention_plain, the plain lane's
# dot_attention: the same f32 arithmetic in another order, 2 layers deep.
GRAD_TOL = 1e-4


def _launches_a_forward(cfg):
    """(K4, K5) launches of one training step: each unit's forward runs
    ``remat.forward_runs`` times (twice where the config rematerialises)."""
    runs = remat.forward_runs(cfg)
    if cfg.family == "ssm":
        return 0, cfg.num_layers * runs
    if cfg.family == "hybrid":
        return cfg.num_layers // cfg.attn_every * runs, 0
    if cfg.family == "encdec":
        return (cfg.encoder_layers + 2 * cfg.num_layers) * runs, 0
    return cfg.num_layers * runs, 0


@pytest.mark.parametrize("arch", ARCHS)
def test_every_family_trains_through_the_kernels(stand_in, monkeypatch, arch):
    from repro_torch.data.synthetic import lm_batch

    cfg = get_config(arch, smoke=True).replace(dtype="float32")
    params = Model(cfg).init(1, device="cpu")
    seq = 16 + (cfg.num_patches if cfg.family == "vlm" else 0)
    batch = {k: torch.from_numpy(v) for k, v in lm_batch(cfg, 2, seq, seed=0).items()}

    def grads(backend):
        flat = [p.clone().requires_grad_(True) for p in leaves(params)]
        loss, _ = Model(cfg, backend=backend).loss_fn(unflatten(params, flat), batch)
        return loss, torch.autograd.grad(loss, flat, allow_unused=True)

    want_loss, want = grads("torch")
    card = lambda backend, device: "cuda" if backend in ("auto", "cuda") else backend  # noqa
    monkeypatch.setattr(A, "resolve_backend", card)
    monkeypatch.setattr(S, "resolve_backend", card)
    k4, k5 = FA.flash_attention.launches, SS.selective_scan.launches
    got_loss, got = grads("auto")
    assert (FA.flash_attention.launches - k4, SS.selective_scan.launches - k5) == \
        _launches_a_forward(cfg)
    assert abs(float(got_loss.detach()) - float(want_loss.detach())) <= 1e-5
    for (path, _), g, w in zip(leaves_with_path(params), got, want):
        assert (g is None) == (w is None), path
        if w is not None:
            scale = float(w.abs().max().clamp_min(1e-30))
            assert float((g - w).abs().max()) <= GRAD_TOL * scale, path
            assert bool(torch.isfinite(g).all())
