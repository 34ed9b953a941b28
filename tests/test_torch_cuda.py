"""The port's CUDA kernels on the card: K1 (csrc/pool_core_fwd.cu) and K2
(csrc/pool_core_bwd.cu) against their plain PyTorch versions, the
Predictor's kernel path against its plain-pool path, one training
iteration through both kernels against the plain pool; K3
(csrc/lstm_fused_fwd.cu) and K4 (csrc/lstm_fused_bwd.cu) against their
plain versions, two K3 and two K4 calls that give equal bits, K3 and K4
on misaligned views, and a training iteration with ``lstm_impl='fused'``
against ``'scan'``; K5 (csrc/lstm_proj_fwd.cu) and K6 (csrc/lstm_proj_bwd.cu)
against their plain versions, two K5 and two K6 calls that give equal bits,
K5 on misaligned views, and a training iteration with
``lstm_impl='pallas'`` against ``'scan'``; Bo20 evaluation of a gat, a
gat-mh and a gcn-pool zoo file on the three routes against the port on
the CPU, with the kernels' launches; a short ``train()`` on 'fused' whose
checkpoint reloads with the run's Adam state bit for bit; K1 and K2 at the
per-step decoder's best-of-20 shape [1280, 64, 512, 8] against their plain
versions, the ``pool_every_timestep`` decoder launching K1 on every decode
step and K2 on every step of its backward, and a ``train()`` of the
``sgan-p`` preset with ``pool_every_timestep`` through a save and a resume;
K1 and K2 through PoolCore's vmap rule at R = 4 against per-replica plain
versions, and a 2-seed ``train_many`` through a save and a resume; K1 and
K2 in their bf16 mode (``grouptraj_torch.ops.precision``) against their
plain versions in that mode, bit for bit on quantized inputs, and a
training iteration and a per-step serving call under the "default"
setting launching only the bf16 mode; K3-K6 at widths past the register
design's (H = 100 and 128, D = 32 and 64: csrc/lstm_wide_*.cu) and
between its built widths (H = 40, D = 12: zero-padded) against their plain
versions, and the wide design bit for bit on a repeat and on misaligned
views.
Marked
``cuda``; each test skips without a CUDA device.
This file imports no JAX, so on a machine without it run

    python -m pytest --noconftest -q tests/test_torch_cuda.py

Tolerances: pooled atol 1e-4 (float32 sums of K=512 products in another
order); ``cnt`` exact (ties come from equal inputs); positions 1e-3 m
(the pool's rounding carried through the GAT and 12 decoder steps); K2's
da/du 1e-5 and dW2/db2 1e-4 relative to the largest reference entry, given
the kernel's own tie selection (see chip_smoke.py:check_bwd for why); the
training iteration's losses 1e-4 relative; K3's outputs 1e-5 absolute and
K4's gradients 1e-4 of each tensor's largest entry (float32 sums of H ≤ 128
products in another order, accurate activations on both sides), and the same
for K5 and K6. In the bf16 mode pooled and K2's four tensors 1e-5 of the
reference's largest entry (the same exact bfloat16 products summed in
another order).
"""

import dataclasses

import numpy as np
import pytest
import torch

pytestmark = pytest.mark.cuda

CKPT = "models/grouptraj/zara1_12_with_model.pt"


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel has no CPU mode)")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _inputs(cuda, R, S, N, B, seed, dtype=torch.float32):
    g = torch.Generator().manual_seed(seed)
    a = torch.randn(R, S, N, 512, generator=g)
    u = torch.randn(R, S, N, 512, generator=g)
    W2 = (torch.randn(R, 512, B, generator=g) / 512 ** 0.5).to(dtype)
    b2 = torch.randn(R, B, generator=g).to(dtype)
    valid = (torch.rand(R, S, N, generator=g) > 0.3).float()
    valid[:, 0] = 0                         # a pad scene
    return [t.to(cuda).contiguous() for t in (a, u, W2, b2, valid)]


@pytest.mark.parametrize("R,S,N,B,dtype", [
    (1, 8, 64, 8, torch.float32), (1, 32, 16, 8, torch.float32),
    (2, 4, 40, 48, torch.float32), (1, 8, 24, 8, torch.bfloat16),
    (1, 128, 64, 48, torch.float32), (1, 64, 64, 48, torch.bfloat16),
    (1, 4, 256, 48, torch.float32)])
def test_kernel_matches_plain(cuda, R, S, N, B, dtype):
    from grouptraj_torch.ops.cuda_pool import pool_core_fwd
    from grouptraj_torch.ops.pooling import pool_core
    a, u, W2, b2, valid = _inputs(cuda, R, S, N, B, seed=N + B, dtype=dtype)
    before = pool_core_fwd.launches
    pooled, cnt = pool_core_fwd(a, u, W2, b2, valid)
    assert pool_core_fwd.launches == before + 1
    ref, ref_cnt = pool_core(a, u, W2, b2, valid)
    torch.cuda.synchronize()
    rows = valid > 0
    assert (pooled - ref)[rows].abs().max().item() <= 1e-4
    assert torch.equal(cnt[rows], ref_cnt[rows])
    assert (pooled[:, 0] == 0).all() and (cnt[:, 0] == 0).all()


def test_kernel_counts_ties(cuda):
    from grouptraj_torch.ops.cuda_pool import pool_core_fwd
    from grouptraj_torch.ops.pooling import pool_core
    a, u, W2, b2, valid = _inputs(cuda, 1, 4, 40, 8, seed=7)
    valid.fill_(1.0)
    a[:, :, 35] = a[:, :, 2]                # duplicate rows in two j-chunks
    b2 -= 2.0                               # many ReLU zeros
    pooled, cnt = pool_core_fwd(a, u, W2, b2, valid)
    ref, ref_cnt = pool_core(a, u, W2, b2, valid)
    assert (ref_cnt > 1).any()
    assert torch.equal(cnt, ref_cnt)


def test_predictor_kernel_path_matches_plain_pool(cuda):
    from grouptraj_torch.ops.cuda_pool import pool_core_fwd
    from grouptraj_torch.serve import Predictor
    p = Predictor.from_checkpoint(CKPT, num_samples=4, param_dtype=None,
                                  device=cuda)
    plain = Predictor({k: v for k, v in p.model.state_dict().items()},
                      dataclasses.replace(p.cfg, pool_impl="fast"),
                      num_samples=4, param_dtype=None, device=cuda)
    rng = np.random.default_rng(0)
    scenes = [np.cumsum(rng.normal(0, 0.4, (n, 8, 2)), 1).astype(np.float32)
              for n in (3, 9, 14)]
    noises = torch.randn(4, 4, 16, 8, device=cuda)
    before = pool_core_fwd.launches
    out = p.predict_batch(scenes, noises=noises)
    assert pool_core_fwd.launches == before + 1
    for o, r in zip(out, plain.predict_batch(scenes, noises=noises)):
        assert np.abs(o - r).max() <= 1e-3


@pytest.mark.parametrize("R,S,N,B", [(1, 8, 64, 8), (1, 16, 40, 48),
                                     (2, 4, 24, 16), (1, 128, 64, 48),
                                     (1, 4, 256, 48)])
def test_backward_kernel_matches_plain(cuda, R, S, N, B):
    from grouptraj_torch.ops.cuda_pool import pool_core_bwd, pool_core_fwd
    from grouptraj_torch.ops.pooling import pool_core_bwd_plain
    a, u, W2, b2, valid = _inputs(cuda, R, S, N, B, seed=N + B)
    pooled, cnt = pool_core_fwd(a, u, W2, b2, valid)
    dpool = torch.randn_like(pooled)            # non-zero at invalid rows too
    dbg = {}
    before = pool_core_bwd.launches
    out = pool_core_bwd(a, u, W2, b2, valid, pooled, cnt, dpool, debug=dbg)
    assert pool_core_bwd.launches == before + 1
    torch.cuda.synchronize()
    rows = valid > 0
    assert torch.equal(dbg["recount"][rows], cnt[rows])
    want = torch.where(rows[..., None] & (pooled > 0), cnt, 0.0)
    assert torch.equal(dbg["ties"].sum(-2).float(), want)
    ref = pool_core_bwd_plain(a, u, W2, b2, valid, pooled, cnt, dpool,
                              ties=dbg["ties"])
    for x, r, tol in zip(out, ref, (1e-5, 1e-5, 1e-4, 1e-4)):
        assert (x - r).abs().max().item() <= tol * max(1.0, r.abs().max().item())
    assert (out[0][~rows] == 0).all() and (out[1][~rows] == 0).all()


def test_backward_kernel_repeats_bit_for_bit(cuda):
    """No float atomics and every sum in a fixed order: two runs on the
    same inputs give the same bits."""
    from grouptraj_torch.ops.cuda_pool import pool_core_bwd, pool_core_fwd
    a, u, W2, b2, valid = _inputs(cuda, 1, 128, 64, 48, seed=5)
    pooled, cnt = pool_core_fwd(a, u, W2, b2, valid)
    dpool = torch.randn_like(pooled)
    first = pool_core_bwd(a, u, W2, b2, valid, pooled, cnt, dpool)
    second = pool_core_bwd(a, u, W2, b2, valid, pooled, cnt, dpool)
    for x, y in zip(first, second):
        assert torch.equal(x, y)
    assert first[0].abs().max() > 0 and first[2].abs().max() > 0


def test_backward_kernel_splits_positive_ties(cuda):
    from grouptraj_torch.ops.cuda_pool import PoolCore
    from grouptraj_torch.ops.pooling import pool_core
    a, u, W2, b2, valid = _inputs(cuda, 1, 4, 40, 8, seed=7)
    valid.fill_(1.0)
    a[:, :, 35] = a[:, :, 2]                # duplicate rows in two j-chunks
    leaves = [t.clone().requires_grad_() for t in (a, u, W2, b2)]
    pooled, cnt = PoolCore.apply(*leaves, valid)
    assert ((cnt > 1) & (pooled > 0)).any()
    pooled.sum().backward()
    da = leaves[0].grad
    assert torch.equal(da[:, :, 35], da[:, :, 2])   # tying rows share evenly
    ref_leaves = [t.clone().requires_grad_() for t in (a, u, W2, b2)]
    pool_core(*ref_leaves, valid)[0].sum().backward()
    for x, r in zip(leaves, ref_leaves):
        assert (x.grad - r.grad).abs().max().item() <= 1e-4 * max(
            1.0, r.grad.abs().max().item())


def test_training_iteration_goes_through_both_kernels(cuda):
    import copy
    from grouptraj_torch.config import ModelConfig, TrainConfig
    from grouptraj_torch.ops.cuda_pool import pool_core_bwd, pool_core_fwd
    from grouptraj_torch.train.device_data import synthetic_device_data
    from grouptraj_torch.train.steps import (
        init_train_state, train_iterations, train_state_from_modules,
    )
    cfg = ModelConfig()
    tcfg = dataclasses.replace(TrainConfig(), best_k=4, bf16_nograd=False)
    state = init_train_state(cfg, tcfg, device=cuda)
    plain_cfg = dataclasses.replace(cfg, pool_impl="fast")
    plain = train_state_from_modules(copy.deepcopy(state.g),
                                     copy.deepcopy(state.d), tcfg)
    plain.g.cfg = plain.d.cfg = plain_cfg
    data = synthetic_device_data(32, 16, device=cuda)
    idx = torch.arange(16, device=cuda).reshape(1, 2, 8)
    fwd, bwd = pool_core_fwd.launches, pool_core_bwd.launches
    out = train_iterations(state, data, idx, cfg, tcfg,
                           generator=torch.Generator(cuda).manual_seed(0))
    assert pool_core_fwd.launches == fwd + 4
    assert pool_core_bwd.launches == bwd + 3
    ref = train_iterations(plain, data, idx, plain_cfg, tcfg,
                           generator=torch.Generator(cuda).manual_seed(0))
    assert (pool_core_fwd.launches, pool_core_bwd.launches) == (fwd + 4,
                                                                bwd + 3)
    for k, v in out.items():
        assert torch.isfinite(v).all()
        assert torch.allclose(v, ref[k], rtol=1e-4, atol=1e-6), k


# ------------------------------------------------ K3 / K4, the fused LSTM

def _weight_scale(H):
    """0.3, and past H = 64 0.3 sqrt(64 / H): gate sums of about the same
    size at every width (the models' init is 1/sqrt(H))."""
    return 0.3 * min(1.0, (64 / H) ** 0.5)


def _lstm_case(cuda, T, B, H, with_gx, seed):
    g = torch.Generator().manual_seed(seed)
    r = lambda *s: torch.randn(*s, generator=g).to(cuda)
    w, h0, c0 = r(H, 4 * H) * _weight_scale(H), r(B, H), r(B, H)
    gx = r(T, B, 4 * H) if with_gx else None
    b = None if with_gx else r(4 * H) * 0.1
    return w, h0, c0, gx, b, (r(T, B, H), r(B, H), r(B, H))


@pytest.mark.parametrize("T,B,H,with_gx", [
    (8, 100, 32, True), (5, 9, 8, True), (20, 40, 48, True),
    (11, 70, 32, False), (7, 9, 16, False), (1, 1, 32, True),
    (3, 33, 64, False), (6, 130, 128, True), (5, 65, 100, False),
    (4, 33, 40, True)])
def test_fused_forward_kernel_matches_plain(cuda, T, B, H, with_gx):
    from grouptraj_torch.ops.cuda_lstm import lstm_fused_fwd
    from grouptraj_torch.ops.lstm import _fused_fwd_plain
    w, h0, c0, gx, b, _ = _lstm_case(cuda, T, B, H, with_gx, seed=T + B)
    for save in (False, True):
        before = lstm_fused_fwd.launches
        out = lstm_fused_fwd(w, h0, c0, gx=gx, b=b, T=T, save=save)
        assert lstm_fused_fwd.launches == before + 1
        ref = _fused_fwd_plain(w, gx, b, h0, c0, T, save)
        torch.cuda.synchronize()
        assert (out[3] is None) == (out[4] is None) == (not save)
        for x, y in zip(out, ref):
            if x is not None:
                assert (x - y).abs().max().item() <= 1e-5


def _shifted(t):
    """A copy of t in a view that starts 4 bytes off a 16-byte boundary."""
    buf = torch.empty(t.numel() + 1, device=t.device)
    view = buf[1:].view(t.shape)
    view.copy_(t)
    assert view.data_ptr() % 16 != 0
    return view


def test_fused_forward_repeats_bit_for_bit(cuda):
    """K3 sums every product in a fixed order and uses no atomics: two calls
    on the same inputs give the same bits, both variants, residuals
    saved."""
    from grouptraj_torch.ops.cuda_lstm import lstm_fused_fwd
    for with_gx in (True, False):
        w, h0, c0, gx, b, _ = _lstm_case(cuda, 11, 4097, 32, with_gx, seed=4)
        first, second = (lstm_fused_fwd(w, h0, c0, gx=gx, b=b, T=11,
                                        save=True) for _ in range(2))
        for x, y in zip(first, second):
            assert torch.equal(x, y) and x.abs().max() > 0


def test_fused_forward_takes_misaligned_views(cuda):
    """K3 reads gx, h0 and c0 eight bytes at a time: the wrapper hands it a
    copy of a view that starts off a 16-byte boundary, and the result is
    the plain version's."""
    from grouptraj_torch.ops.cuda_lstm import lstm_fused_fwd
    from grouptraj_torch.ops.lstm import _fused_fwd_plain
    T, B, H = 6, 70, 48
    w, h0, c0, gx, _, _ = _lstm_case(cuda, T, B, H, True, seed=6)
    got = lstm_fused_fwd(w, _shifted(h0), _shifted(c0), gx=_shifted(gx),
                         save=True)
    ref = _fused_fwd_plain(w, gx, None, h0, c0, T, True)
    torch.cuda.synchronize()
    for x, y in zip(got, ref):
        assert (x - y).abs().max().item() <= 1e-5


@pytest.mark.parametrize("T,B,H,with_gx", [
    (8, 50, 32, True), (6, 16, 16, True), (20, 40, 48, True),
    (11, 24, 32, False), (7, 9, 8, False), (1, 1, 48, True),
    (20, 8192, 48, True), (11, 8192, 32, False), (3, 4097, 8, True),
    (4, 40, 64, True), (3, 33, 64, False), (6, 130, 128, True),
    (5, 65, 100, False), (4, 33, 40, False)])
def test_fused_backward_kernel_matches_plain(cuda, T, B, H, with_gx):
    from grouptraj_torch.ops.cuda_lstm import lstm_fused_bwd, lstm_fused_fwd
    from grouptraj_torch.ops.lstm import fused_recurrence_bwd_plain
    w, h0, c0, gx, b, (dys, dhT, dcT) = _lstm_case(cuda, T, B, H, with_gx,
                                                   seed=T * B)
    ys, _, _, gates, cs = lstm_fused_fwd(w, h0, c0, gx=gx, b=b, T=T,
                                         save=True)
    cots = [(dys, dhT, dcT), (None, dhT, None)] if with_gx \
        else [(dys, None, None)]
    for cot in cots:
        before = lstm_fused_bwd.launches
        got = lstm_fused_bwd(w, h0, c0, ys, gates, cs, *cot, with_gx)
        assert lstm_fused_bwd.launches == before + 1
        ref = fused_recurrence_bwd_plain(w, h0, c0, ys, gates, cs, *cot,
                                         with_gx)
        torch.cuda.synchronize()
        for x, y in zip(got, ref):
            assert (x is None) == (y is None)
            if x is not None:
                assert (x - y).abs().max().item() <= 1e-4 * max(
                    y.abs().max().item(), 1e-30)


def test_fused_backward_repeats_bit_for_bit(cuda):
    """K4 sums every partial in a fixed order and uses no float atomics:
    two calls on the same inputs give the same bits, both variants."""
    from grouptraj_torch.ops.cuda_lstm import lstm_fused_bwd, lstm_fused_fwd
    for with_gx in (True, False):
        w, h0, c0, gx, b, (dys, dhT, dcT) = _lstm_case(cuda, 20, 4097, 48,
                                                       with_gx, seed=3)
        ys, _, _, gates, cs = lstm_fused_fwd(w, h0, c0, gx=gx, b=b, T=20,
                                             save=True)
        cot = (dys, dhT, dcT) if with_gx else (dys, None, None)
        args = (w, h0, c0, ys, gates, cs, *cot, with_gx)
        first, second = lstm_fused_bwd(*args), lstm_fused_bwd(*args)
        for x, y in zip(first, second):
            assert (x is None) == (y is None)
            if x is not None:
                assert torch.equal(x, y) and x.abs().max() > 0


def test_fused_backward_takes_misaligned_views(cuda):
    """K4 copies its inputs by cp.async, 16 bytes at a time: the wrapper
    hands it a copy of a view that starts off a 16-byte boundary, and the
    result is the plain version's."""
    from grouptraj_torch.ops.cuda_lstm import lstm_fused_bwd, lstm_fused_fwd
    from grouptraj_torch.ops.lstm import fused_recurrence_bwd_plain
    T, B, H = 5, 70, 32
    w, h0, c0, gx, _, (dys, dhT, dcT) = _lstm_case(cuda, T, B, H, True,
                                                   seed=5)
    ys, _, _, gates, cs = lstm_fused_fwd(w, h0, c0, gx=gx, save=True)
    args = [_shifted(t) for t in (h0, c0, ys, gates, cs, dys)]
    got = lstm_fused_bwd(w, *args[:5], args[5], dhT, dcT, True)
    ref = fused_recurrence_bwd_plain(w, h0, c0, ys, gates, cs, dys, dhT,
                                     dcT, True)
    torch.cuda.synchronize()
    for x, y in zip(got, ref):
        assert (x is None) == (y is None)
        if x is not None:
            assert (x - y).abs().max().item() <= 1e-4 * y.abs().max().item()


def test_fused_functions_differentiate_through_the_kernels(cuda):
    from grouptraj_torch.ops import cuda_lstm as CL
    from grouptraj_torch.ops import lstm as TL
    w, h0, c0, gx, _, _ = _lstm_case(cuda, 8, 70, 32, True, seed=1)
    leaves = [t.clone().requires_grad_() for t in (w, gx, h0, c0)]
    fwd, bwd = CL.lstm_fused_fwd.launches, CL.lstm_fused_bwd.launches
    ys, (hT, cT) = CL.lstm_recurrence_fused(*leaves)
    got = torch.autograd.grad((ys ** 2).sum() + (hT * cT).sum(), leaves)
    assert (CL.lstm_fused_fwd.launches, CL.lstm_fused_bwd.launches) == (
        fwd + 1, bwd + 1)
    ref_leaves = [t.clone().requires_grad_() for t in (w, gx, h0, c0)]
    ys, hT, cT, _, _ = TL.lstm_recurrence_fused_plain(*ref_leaves)
    ref = torch.autograd.grad((ys ** 2).sum() + (hT * cT).sum(), ref_leaves)
    for x, y in zip(got, ref):
        assert (x - y).abs().max().item() <= 1e-4 * y.abs().max().item()
    with pytest.raises(ValueError):                # H past the kernels'
        CL.lstm_fused_fwd(torch.zeros(129, 516, device=cuda),
                          torch.zeros(3, 129, device=cuda),
                          torch.zeros(3, 129, device=cuda),
                          b=torch.zeros(516, device=cuda), T=2)


def test_fused_training_iteration_matches_scan(cuda):
    import copy
    from grouptraj_torch.config import ModelConfig, TrainConfig
    from grouptraj_torch.ops.cuda_lstm import lstm_fused_bwd, lstm_fused_fwd
    from grouptraj_torch.train.device_data import synthetic_device_data
    from grouptraj_torch.train.steps import (
        init_train_state, train_iterations, train_state_from_modules,
    )
    cfg = ModelConfig()
    fused = dataclasses.replace(TrainConfig(), best_k=4, bf16_nograd=False,
                                lstm_impl="fused")
    scan = dataclasses.replace(fused, lstm_impl="scan")
    state = init_train_state(cfg, fused, device=cuda)
    ref_state = train_state_from_modules(copy.deepcopy(state.g),
                                         copy.deepcopy(state.d), scan)
    data = synthetic_device_data(32, 16, device=cuda)
    idx = torch.arange(16, device=cuda).reshape(1, 2, 8)
    fwd, bwd = lstm_fused_fwd.launches, lstm_fused_bwd.launches
    out = train_iterations(state, data, idx, cfg, fused,
                           generator=torch.Generator(cuda).manual_seed(0))
    assert (lstm_fused_fwd.launches, lstm_fused_bwd.launches) == (fwd + 7,
                                                                  bwd + 4)
    ref = train_iterations(ref_state, data, idx, cfg, scan,
                           generator=torch.Generator(cuda).manual_seed(0))
    assert (lstm_fused_fwd.launches, lstm_fused_bwd.launches) == (fwd + 7,
                                                                  bwd + 4)
    for k, v in out.items():
        assert torch.isfinite(v).all()
        assert torch.allclose(v, ref[k], rtol=1e-4, atol=1e-6), k


# ------------------------- K5 / K6, the LSTM with its projection in the kernel

def _proj_case(cuda, T, B, D, H, seed):
    g = torch.Generator().manual_seed(seed)
    r = lambda *s: torch.randn(*s, generator=g).to(cuda)
    ws = _weight_scale(H)
    w_ih, w_hh, b = r(D, 4 * H) * ws, r(H, 4 * H) * ws, r(4 * H) * 0.1
    return w_ih, w_hh, b, r(T, B, D), r(B, H), r(B, H), (r(T, B, H),
                                                          r(B, H), r(B, H))


@pytest.mark.parametrize("T,B,D,H", [(8, 100, 16, 32), (20, 70, 16, 48),
                                     (5, 9, 4, 8), (6, 40, 8, 64),
                                     (20, 8192, 16, 48), (3, 4097, 4, 8),
                                     (4, 33, 16, 64), (5, 70, 32, 128),
                                     (4, 33, 12, 100), (3, 17, 64, 64)])
def test_proj_kernels_match_plain(cuda, T, B, D, H):
    """K5 with and without residuals, then K6 on K5's residuals with all
    cotangents and with only dhT, against their plain versions."""
    from grouptraj_torch.ops.cuda_lstm_proj import lstm_proj_bwd, lstm_proj_fwd
    from grouptraj_torch.ops.lstm import (
        lstm_proj_bwd_plain, lstm_proj_fwd_plain,
    )
    w_ih, w_hh, b, xs, h0, c0, (dys, dhT, dcT) = _proj_case(
        cuda, T, B, D, H, seed=T + B)
    for save in (False, True):
        before = lstm_proj_fwd.launches
        out = lstm_proj_fwd(w_ih, w_hh, b, xs, h0, c0, save=save)
        assert lstm_proj_fwd.launches == before + 1
        ref = lstm_proj_fwd_plain(w_ih, w_hh, b, xs, h0, c0, save)
        torch.cuda.synchronize()
        assert (out[3] is None) == (out[4] is None) == (not save)
        for x, y in zip(out, ref):
            if x is not None:
                assert (x - y).abs().max().item() <= 1e-5
    ys, _, _, gates, cs = out
    for cot in ((dys, dhT, dcT), (None, dhT, None)):
        before = lstm_proj_bwd.launches
        got = lstm_proj_bwd(w_ih, w_hh, xs, h0, c0, ys, gates, cs, *cot)
        assert lstm_proj_bwd.launches == before + 1
        want = lstm_proj_bwd_plain(w_ih, w_hh, xs, h0, c0, ys, gates, cs,
                                   *cot)
        torch.cuda.synchronize()
        for x, y in zip(got, want):
            assert x.shape == y.shape and bool(torch.isfinite(x).all())
            assert (x - y).abs().max().item() <= 1e-4 * max(
                y.abs().max().item(), 1e-30)


def test_proj_forward_repeats_bit_for_bit(cuda):
    """K5 sums every product in a fixed order and uses no atomics: two calls
    on the same inputs give the same bits, residuals saved."""
    from grouptraj_torch.ops.cuda_lstm_proj import lstm_proj_fwd
    w_ih, w_hh, b, xs, h0, c0, _ = _proj_case(cuda, 20, 4097, 16, 48, seed=5)
    first, second = (lstm_proj_fwd(w_ih, w_hh, b, xs, h0, c0, save=True)
                     for _ in range(2))
    for x, y in zip(first, second):
        assert torch.equal(x, y) and x.abs().max() > 0


def test_proj_forward_takes_misaligned_views(cuda):
    """K5 copies xs 16 bytes at a time and reads h0 and c0 eight bytes at a
    time: the wrapper hands it a copy of a view that starts off a 16-byte
    boundary, and the result is the plain version's."""
    from grouptraj_torch.ops.cuda_lstm_proj import lstm_proj_fwd
    from grouptraj_torch.ops.lstm import lstm_proj_fwd_plain
    w_ih, w_hh, b, xs, h0, c0, _ = _proj_case(cuda, 6, 70, 16, 48, seed=6)
    got = lstm_proj_fwd(w_ih, w_hh, b, _shifted(xs), _shifted(h0),
                        _shifted(c0), save=True)
    ref = lstm_proj_fwd_plain(w_ih, w_hh, b, xs, h0, c0, save=True)
    torch.cuda.synchronize()
    for x, y in zip(got, ref):
        assert (x - y).abs().max().item() <= 1e-5


def test_proj_backward_repeats_bit_for_bit(cuda):
    """K6 sums every partial in a fixed order and uses no float atomics:
    two calls on the same inputs give the same bits."""
    from grouptraj_torch.ops.cuda_lstm_proj import lstm_proj_bwd, lstm_proj_fwd
    w_ih, w_hh, b, xs, h0, c0, (dys, dhT, dcT) = _proj_case(
        cuda, 20, 4097, 16, 48, seed=3)
    ys, _, _, gates, cs = lstm_proj_fwd(w_ih, w_hh, b, xs, h0, c0, save=True)
    args = (w_ih, w_hh, xs, h0, c0, ys, gates, cs, dys, dhT, dcT)
    first, second = lstm_proj_bwd(*args), lstm_proj_bwd(*args)
    for x, y in zip(first, second):
        assert torch.equal(x, y)
    assert all(x.abs().max() > 0 for x in first)


def test_wide_kernels_repeat_bit_for_bit_and_take_misaligned_views(cuda):
    """K3-K6 in their wide design (H = 128, D = 32; csrc/lstm_wide_*.cu):
    every launch counted as a wide one, two calls on the same inputs give
    the same bits (no float atomics; the weight gradients' partials summed
    in chunk order), and views off a 16-byte boundary (the wrappers copy
    them) give the same bits again."""
    from grouptraj_torch.ops.cuda_lstm import lstm_fused_bwd, lstm_fused_fwd
    from grouptraj_torch.ops.cuda_lstm_proj import lstm_proj_bwd, lstm_proj_fwd

    def same(call, args, shift):
        first, second = call(*args), call(*args)
        moved = [_shifted(a) if i in shift and a is not None else a
                 for i, a in enumerate(args)]
        third = call(*moved)
        for x, y, z in zip(first, second, third):
            assert (x is None) == (y is None) == (z is None)
            if x is not None:
                assert torch.equal(x, y) and torch.equal(x, z)
                assert x.abs().max() > 0
        return first

    T, B, H, D = 7, 4097, 128, 32
    wide = [f.launches_wide for f in (lstm_fused_fwd, lstm_fused_bwd,
                                      lstm_proj_fwd, lstm_proj_bwd)]
    for with_gx in (True, False):
        w, h0, c0, gx, b, (dys, dhT, dcT) = _lstm_case(cuda, T, B, H,
                                                       with_gx, seed=9)
        ys, _, _, gates, cs = same(
            lambda w, h0, c0, gx, b: lstm_fused_fwd(w, h0, c0, gx=gx, b=b,
                                                    T=T, save=True),
            (w, h0, c0, gx, b), (1, 2, 3, 4))
        cot = (dys, dhT, dcT) if with_gx else (dys, None, None)
        same(lstm_fused_bwd, (w, h0, c0, ys, gates, cs, *cot, with_gx),
             (1, 2, 3, 4, 5, 6))
    w_ih, w_hh, b, xs, h0, c0, (dys, dhT, dcT) = _proj_case(cuda, T, B, D, H,
                                                            seed=10)
    ys, _, _, gates, cs = same(lambda *a: lstm_proj_fwd(*a, save=True),
                               (w_ih, w_hh, b, xs, h0, c0), (2, 3, 4, 5))
    same(lstm_proj_bwd, (w_ih, w_hh, xs, h0, c0, ys, gates, cs, dys, dhT,
                         dcT), (2, 3, 4, 5, 6, 7, 8))
    counts = [f.launches_wide - n for f, n in zip(
        (lstm_fused_fwd, lstm_fused_bwd, lstm_proj_fwd, lstm_proj_bwd), wide)]
    assert counts == [6, 6, 3, 3]


def test_pallas_training_iteration_matches_scan(cuda):
    """Through train_iterations with ``lstm_impl='pallas'``: K5 four times
    and K6 three times per iteration, losses equal to the scan route's."""
    import copy
    from grouptraj_torch.config import ModelConfig, TrainConfig
    from grouptraj_torch.ops.cuda_lstm_proj import lstm_proj_bwd, lstm_proj_fwd
    from grouptraj_torch.train.device_data import synthetic_device_data
    from grouptraj_torch.train.steps import (
        init_train_state, train_iterations, train_state_from_modules,
    )
    cfg = ModelConfig()
    pallas = dataclasses.replace(TrainConfig(), best_k=4, bf16_nograd=False,
                                 lstm_impl="pallas")
    scan = dataclasses.replace(pallas, lstm_impl="scan")
    state = init_train_state(cfg, pallas, device=cuda)
    ref_state = train_state_from_modules(copy.deepcopy(state.g),
                                         copy.deepcopy(state.d), scan)
    data = synthetic_device_data(32, 16, device=cuda)
    idx = torch.arange(16, device=cuda).reshape(1, 2, 8)
    fwd, bwd = lstm_proj_fwd.launches, lstm_proj_bwd.launches
    out = train_iterations(state, data, idx, cfg, pallas,
                           generator=torch.Generator(cuda).manual_seed(0))
    assert (lstm_proj_fwd.launches, lstm_proj_bwd.launches) == (fwd + 4,
                                                                bwd + 3)
    ref = train_iterations(ref_state, data, idx, cfg, scan,
                           generator=torch.Generator(cuda).manual_seed(0))
    assert (lstm_proj_fwd.launches, lstm_proj_bwd.launches) == (fwd + 4,
                                                                bwd + 3)
    for k, v in out.items():
        assert torch.isfinite(v).all()
        assert torch.allclose(v, ref[k], rtol=1e-4, atol=1e-6), k


@pytest.mark.parametrize("name", ["zara1_12", "univ_12", "zara1_12_gcnpool"])
def test_zoo_eval_on_card_matches_cpu(cuda, name, tmp_path):
    """evaluate_bucketed on a small synthetic split (natively windowed)
    with the same injected noises: each route on the card within 1e-4
    relative of the port on the CPU; K1 launched for the pool_net models
    only, K3 on 'fused', K5 on 'pallas'."""
    from grouptraj_torch.data import TrajectoryDataset
    from grouptraj_torch.data.synthetic import write_scene_files
    from grouptraj_torch.eval import evaluate_bucketed
    from grouptraj_torch.eval.evaluate_model import get_generator
    from grouptraj_torch.ops.cuda_lstm import lstm_fused_fwd
    from grouptraj_torch.ops.cuda_lstm_proj import lstm_proj_fwd
    from grouptraj_torch.ops.cuda_pool import pool_core_fwd
    from grouptraj_torch.train.checkpoint import load_checkpoint

    write_scene_files(str(tmp_path), n_files=2, frames=80, max_peds=20,
                      seed=1)
    dset = TrajectoryDataset(str(tmp_path), use_native=True)
    path = f"models/grouptraj/{name}_with_model.pt"
    g = torch.Generator().manual_seed(0)
    table = {}

    def noises(i, S, N):
        if i not in table:
            table[i] = torch.randn(20, S, N, 8, generator=g)
        return table[i]

    ref = evaluate_bucketed(get_generator(load_checkpoint(path))[1], dset,
                            20, 16, noises=noises, device="cpu")
    model = get_generator(load_checkpoint(path))[1]
    for impl, kernel in (("scan", None), ("fused", lstm_fused_fwd),
                         ("pallas", lstm_proj_fwd)):
        k1, k = pool_core_fwd.launches, kernel and kernel.launches
        got = evaluate_bucketed(
            model, dset, 20, 16, noises=lambda i, S, N: noises(i, S, N).to(
                cuda), impl=impl, device=cuda)
        np.testing.assert_allclose(got, ref, rtol=1e-4, atol=0,
                                   err_msg=impl)
        assert (pool_core_fwd.launches > k1) == (name != "zara1_12_gcnpool")
        assert kernel is None or kernel.launches > k


def test_fused_training_loop_saves_and_reloads_adam(cuda, tmp_path,
                                                    monkeypatch):
    """A 6-iteration train() on 'fused' at narrow width on a small
    synthetic split: K3 and K4 launched at least 7 and 4 times an
    iteration, both files written, and the file reloads into a state whose
    Adam exp_avg, exp_avg_sq and step equal the run's bit for bit."""
    import os
    from grouptraj_torch.config import ModelConfig, TrainConfig
    from grouptraj_torch.data.synthetic import write_scene_files
    from grouptraj_torch.ops.cuda_lstm import lstm_fused_bwd, lstm_fused_fwd
    from grouptraj_torch.train import checkpoint as CK
    from grouptraj_torch.train.loop import train
    for split, seed in (("train", 0), ("val", 1)):
        write_scene_files(str(tmp_path / "synth" / split), n_files=1,
                          frames=60, max_peds=12, seed=seed)
    monkeypatch.setenv("GROUPTRAJ_DATA_DIR", str(tmp_path))
    cfg = ModelConfig(embedding_dim=8, encoder_h_dim_g=16,
                      decoder_h_dim_g=16, noise_dim=(4,), bottleneck_dim=4,
                      hidden_units=12, graph_out_dim=8, encoder_h_dim_d=16,
                      mlp_dim=16)
    tcfg = TrainConfig(dataset_name="synth", batch_size=8, best_k=4,
                       num_epochs=0, num_iterations=6, steps_per_dispatch=3,
                       print_every=3, checkpoint_every=3, n_buckets=2,
                       num_samples_check=50, lstm_impl="fused", seed=6,
                       output_dir=str(tmp_path / "out"), checkpoint_name="ck")
    fwd, bwd = lstm_fused_fwd.launches, lstm_fused_bwd.launches
    ckpt, state = train(cfg, tcfg, device=cuda, return_state=True)
    assert lstm_fused_fwd.launches - fwd >= 7 * 6
    assert lstm_fused_bwd.launches - bwd >= 4 * 6
    assert ckpt["counters"]["t"] == 6 and len(ckpt["norm_g"]) == 6
    assert np.isfinite(ckpt["norm_g"]).all()
    for name in ("ck_with_model.pt", "ck_no_model.pt"):
        assert os.path.isfile(tmp_path / "out" / name)
    loaded = CK.load_checkpoint(str(tmp_path / "out" / "ck_with_model.pt"))
    again = CK.state_from_checkpoint(loaded, cfg, tcfg, cuda)
    for opt, module, opt2, module2 in ((state.g_opt, state.g, again.g_opt,
                                        again.g),
                                       (state.d_opt, state.d, again.d_opt,
                                        again.d)):
        params2 = dict(module2.named_parameters())
        for name, p in module.named_parameters():
            st, st2 = opt.state[p], opt2.state[params2[name]]
            assert set(st) == set(st2) == {"step", "exp_avg", "exp_avg_sq"}
            for k in st:
                assert torch.equal(st[k], st2[k]), (name, k)
            assert float(st["step"]) == 6


# ------------------------------------- per-step pooling in the decoder loop

def _chunked_plain(fn, a, u, W2, b2, valid, *rest, chunk=128):
    """A plain pool function over scene chunks (scenes are independent;
    the weight gradients, when returned, sum over the chunks): the plain
    versions materialise [S, N, N, K] slabs, too wide at S = 1,280."""
    outs = [fn(a[:, s:s + chunk], u[:, s:s + chunk], W2, b2,
               valid[:, s:s + chunk], *[t[:, s:s + chunk] for t in rest])
            for s in range(0, a.shape[1], chunk)]
    return [torch.cat(parts, 1) if parts[0].dim() == a.dim() else
            sum(parts) for parts in zip(*outs)]


def test_per_step_pool_shape_matches_plain(cuda):
    """K1 and K2 at the per-step decoder's shape in a best-of-20 decode,
    [K·S, N, 512, 8] = [1280, 64, 512, 8], against their plain versions:
    pooled atol 1e-4, cnt exact, da/du 1e-5 and dW2/db2 1e-4 of the
    largest reference entry given the kernel's tie selection."""
    from grouptraj_torch.ops.cuda_pool import pool_core_bwd, pool_core_fwd
    from grouptraj_torch.ops.pooling import pool_core, pool_core_bwd_plain
    a, u, W2, b2, valid = _inputs(cuda, 1, 1280, 64, 8, seed=12)
    pooled, cnt = pool_core_fwd(a, u, W2, b2, valid)
    ref, ref_cnt = _chunked_plain(pool_core, a, u, W2, b2, valid)
    rows = valid > 0
    assert (pooled - ref)[rows].abs().max().item() <= 1e-4
    assert torch.equal(cnt[rows], ref_cnt[rows])
    dpool = torch.randn_like(pooled)
    dbg = {}
    out = pool_core_bwd(a, u, W2, b2, valid, pooled, cnt, dpool, debug=dbg)
    assert torch.equal(dbg["recount"][rows], cnt[rows])
    ref = _chunked_plain(
        lambda *t: pool_core_bwd_plain(*t[:8], ties=t[8]), a, u, W2, b2,
        valid, pooled, cnt, dpool, dbg["ties"])
    for x, r, tol in zip(out, ref, (1e-5, 1e-5, 1e-4, 1e-4)):
        assert (x - r).abs().max().item() <= tol * max(1.0, r.abs().max().item())


def test_per_step_decoder_launches_k1_every_step(cuda):
    """The gat preset with pool_every_timestep on the card: K1 once for
    the context and once per decode step; in the backward K2 for the
    context and every decode step but the last, whose re-pooled state
    feeds no output (autograd skips it; the JAX scan discards it too);
    positions against the plain pool within 1e-3 m."""
    from grouptraj_torch.config import ModelConfig
    from grouptraj_torch.models.generator import TrajectoryGenerator
    from grouptraj_torch.ops.cuda_pool import pool_core_bwd, pool_core_fwd
    from grouptraj_torch.train.device_data import (
        gather_batch, synthetic_device_data,
    )
    torch.manual_seed(0)
    cfg = ModelConfig(pool_every_timestep=True)
    g = TrajectoryGenerator(cfg).to(cuda)
    b = gather_batch(synthetic_device_data(16, 32, device=cuda),
                     torch.arange(8, device=cuda), cfg.obs_len)
    z = torch.randn(4, 8, 32, 8, device=cuda)

    def run(model):
        ctx = model.generator_context(b["obs"], b["obs_rel"], b["group"],
                                      b["valid"])
        return model.generator_sample_many(ctx, b["obs_rel"], b["valid"], 4,
                                           user_noises=z, obs=b["obs"],
                                           group_end=b["group"])

    fwd, bwd = pool_core_fwd.launches, pool_core_bwd.launches
    preds = run(g)
    assert pool_core_fwd.launches - fwd == 1 + cfg.pred_len
    preds.square().sum().backward()
    assert pool_core_bwd.launches - bwd == 1 + cfg.pred_len - 1
    plain = TrajectoryGenerator(dataclasses.replace(cfg, pool_impl="fast"))
    plain.load_state_dict(g.state_dict())
    with torch.no_grad():
        ref = run(plain.to(cuda))
    assert pool_core_fwd.launches - fwd == 1 + cfg.pred_len
    assert (preds.detach() - ref).abs().max().item() <= 1e-3


def test_sgan_p_per_step_training_loop_saves_and_reloads(cuda, tmp_path,
                                                         monkeypatch):
    """train() of the sgan-p preset with pool_every_timestep (dense
    best-of-k: K1 and K2 on every decode step) for 4 iterations on a small
    synthetic split, then a resume to 6 from its file: finite losses, K2
    launched at least pred_len times an iteration, and the file reloads
    into a state whose Adam moments equal the first run's bit for bit."""
    from grouptraj_torch.config import MODEL_PRESETS, TrainConfig
    from grouptraj_torch.data.synthetic import write_scene_files
    from grouptraj_torch.ops.cuda_pool import pool_core_bwd
    from grouptraj_torch.train import checkpoint as CK
    from grouptraj_torch.train.loop import train
    for split, seed in (("train", 0), ("val", 1)):
        write_scene_files(str(tmp_path / "synth" / split), n_files=1,
                          frames=60, max_peds=12, seed=seed)
    monkeypatch.setenv("GROUPTRAJ_DATA_DIR", str(tmp_path))
    cfg = dataclasses.replace(MODEL_PRESETS["sgan-p"],
                              pool_every_timestep=True)
    tcfg = TrainConfig(dataset_name="synth", batch_size=8, best_k=4,
                       num_epochs=0, num_iterations=4, steps_per_dispatch=2,
                       print_every=2, checkpoint_every=2, n_buckets=2,
                       num_samples_check=50, lstm_impl="fused", seed=6,
                       output_dir=str(tmp_path / "out"), checkpoint_name="ck")
    bwd = pool_core_bwd.launches
    ckpt, state = train(cfg, tcfg, device=cuda, return_state=True)
    assert pool_core_bwd.launches - bwd >= 4 * cfg.pred_len
    assert ckpt["counters"]["t"] == 4 and np.isfinite(ckpt["norm_g"]).all()
    path = str(tmp_path / "out" / "ck_with_model.pt")
    again = CK.state_from_checkpoint(CK.load_checkpoint(path), cfg, tcfg,
                                     cuda)
    params2 = dict(again.g.named_parameters())
    assert "decoder.pool_net.mlp_pre_pool.0.weight" in params2
    for name, p in state.g.named_parameters():
        st, st2 = state.g_opt.state[p], again.g_opt.state[params2[name]]
        for k in ("exp_avg", "exp_avg_sq"):
            assert torch.equal(st[k], st2[k]), (name, k)
    ckpt = train(cfg, dataclasses.replace(tcfg, num_iterations=6),
                 device=cuda)
    assert ckpt["counters"]["t"] == 6 and ckpt["restore_ts"]


# ------------------------------------------- multi-seed sweeps (train_many)

@pytest.mark.parametrize("S,N,B", [(64, 64, 8), (32, 40, 48)])
def test_pool_vmap_rule_at_r4_matches_plain(cuda, S, N, B):
    """PoolCore under torch.func.vmap over 4 replicas (b2 and valid shared)
    launches K1 once and K2 once at R = 4; per replica, pooled matches the
    plain version (atol 1e-4, cnt exact, valid rows only) and the
    gradients match the plain backward given the kernel's own selection
    (K2 called on the merged R = 4 tensors with ``debug``)."""
    from grouptraj_torch.ops.cuda_pool import (
        PoolCore, pool_core_bwd, pool_core_fwd,
    )
    from grouptraj_torch.ops.pooling import pool_core, pool_core_bwd_plain
    n = 4
    a, u, W2, b2, valid = _inputs(cuda, n, S, N, B, seed=S + B)
    b2, valid = b2[0], valid[0]
    leaves = [t.clone().requires_grad_() for t in (a, u, W2, b2)]

    def one(a_, u_, W2_):
        p, c = PoolCore.apply(a_[None], u_[None], W2_[None],
                              leaves[3][None], valid[None])
        return p[0], c[0]

    fwd, bwd = pool_core_fwd.launches, pool_core_bwd.launches
    pooled, cnt = torch.func.vmap(one)(*leaves[:3])
    dpool = torch.randn_like(pooled)
    (pooled * dpool).sum().backward()
    torch.cuda.synchronize()
    assert (pool_core_fwd.launches - fwd, pool_core_bwd.launches - bwd) \
        == (1, 1)
    rows = valid > 0
    merged = [a, u, W2, b2.expand(n, B).contiguous(),
              valid.expand(n, S, N).contiguous()]
    dbg = {}
    kernel_grads = pool_core_bwd(*merged, pooled.detach(), cnt,
                                 dpool.contiguous(), debug=dbg)
    for x, k in zip(leaves[:3], kernel_grads[:3]):
        assert torch.equal(x.grad, k)           # the same launch, R = 4
    db2 = torch.zeros(B, device=cuda)
    for r in range(n):
        ref, ref_cnt = pool_core(a[r:r + 1], u[r:r + 1], W2[r:r + 1],
                                 b2[None], valid[None])
        assert (pooled[r][rows] - ref[0][rows]).abs().max() <= 1e-4
        assert torch.equal(cnt[r][rows], ref_cnt[0][rows])
        g = pool_core_bwd_plain(a[r:r + 1], u[r:r + 1], W2[r:r + 1],
                                b2[None], valid[None], pooled[r:r + 1]
                                .detach(), cnt[r:r + 1], dpool[r:r + 1],
                                ties=dbg["ties"][r:r + 1])
        for x, ref_g, tol in zip((leaves[0].grad[r], leaves[1].grad[r],
                                  leaves[2].grad[r]), g[:3],
                                 (1e-5, 1e-5, 1e-4)):
            assert (x - ref_g[0]).abs().max().item() <= tol * max(
                1.0, ref_g.abs().max().item())
        db2 += g[3][0]
    assert (leaves[3].grad - db2).abs().max().item() <= 1e-4 * max(
        1.0, db2.abs().max().item())


def test_train_many_on_card_saves_and_resumes(cuda, tmp_path, monkeypatch):
    """A 2-seed train_many at narrow width on a small synthetic split for
    4 iterations, then resumed from its files to 6: K2 exactly 3 and K1 at
    least 4 launches an iteration, every launch at R = 2, no K3 although
    lstm_impl says 'fused' (a sweep runs on 'scan'); per-seed files
    with finite histories; the resume continues the counters and each
    replica's generator state is saved."""
    import os
    from grouptraj_torch.config import ModelConfig, TrainConfig
    from grouptraj_torch.data.synthetic import write_scene_files
    from grouptraj_torch.ops import cuda_pool
    from grouptraj_torch.ops.cuda_lstm import lstm_fused_fwd
    from grouptraj_torch.train import checkpoint as CK
    from grouptraj_torch.train import multi as MULTI
    for split, seed in (("train", 0), ("val", 1)):
        write_scene_files(str(tmp_path / "synth" / split), n_files=1,
                          frames=60, max_peds=12, seed=seed)
    monkeypatch.setenv("GROUPTRAJ_DATA_DIR", str(tmp_path))
    cfg = ModelConfig(embedding_dim=8, encoder_h_dim_g=16,
                      decoder_h_dim_g=16, noise_dim=(4,), bottleneck_dim=4,
                      hidden_units=12, graph_out_dim=8, encoder_h_dim_d=16,
                      mlp_dim=16)
    tcfg = TrainConfig(dataset_name="synth", batch_size=8, best_k=4,
                       num_epochs=0, num_iterations=4, steps_per_dispatch=2,
                       print_every=2, checkpoint_every=2, n_buckets=2,
                       num_samples_check=50, lstm_impl="fused", seed=6,
                       output_dir=str(tmp_path / "out"), checkpoint_name="ck")
    real = (cuda_pool.pool_core_fwd, cuda_pool.pool_core_bwd)
    rs = []

    class Recorded:
        """Records R; ``launches`` is the wrapped function's (its body
        counts through the module's name, which is this object here)."""

        def __init__(self, fn):
            self.fn = fn

        launches = property(lambda self: self.fn.launches,
                            lambda self, v: setattr(self.fn, "launches", v))

        def __call__(self, *args, **kw):
            rs.append(args[0].shape[0])
            return self.fn(*args, **kw)
    monkeypatch.setattr(cuda_pool, "pool_core_fwd", Recorded(real[0]))
    monkeypatch.setattr(cuda_pool, "pool_core_bwd", Recorded(real[1]))
    seeds = [6, 7]
    before = [fn.launches for fn in real]
    k3 = lstm_fused_fwd.launches
    ckpts = MULTI.train_many(cfg, tcfg, seeds, device=cuda)
    torch.cuda.synchronize()
    k1_n, k2_n = (fn.launches - b for fn, b in zip(real, before))
    assert k2_n == 3 * 4 and k1_n >= 4 * 4 and set(rs) == {2}
    assert lstm_fused_fwd.launches == k3      # 'fused' runs as 'scan' here
    for s in seeds:
        ck = ckpts[s]
        assert ck["counters"]["t"] == 4 and ck["args"]["seed"] == s
        assert np.isfinite(ck["norm_g"]).all() and len(ck["norm_g"]) == 4
        for name in ("ck_with_model.pt", "ck_no_model.pt"):
            assert os.path.isfile(tmp_path / "out" / f"s{s}" / name)
        saved = CK.load_checkpoint(str(tmp_path / "out" / f"s{s}" /
                                       "ck_with_model.pt"))
        assert saved[MULTI.RNG_KEY] is not None
    again = MULTI.train_many(cfg, dataclasses.replace(
        tcfg, num_iterations=6, restore_from_checkpoint=True), seeds,
        device=cuda)
    for s in seeds:
        assert again[s]["counters"]["t"] == 6
        assert again[s]["restore_ts"] == [4]
        assert len(again[s]["norm_g"]) == 6
        assert np.isfinite(again[s]["norm_d"]).all()


# --------------------------------------- K1 / K2 in the bf16 mode


def _assert_cnt_or_near_tie(cnt, ref, ref_cnt, a, u, W2, b2, valid,
                            atol=1e-5):
    """K1's bf16-mode cnt equals the plain version's on valid rows, but
    where the two orders of summation resolved a near-tie differently:
    there it lies between 1 and the number of valid j whose plain value is
    within ``atol`` of the plain max (chip_smoke.check_kernel's rule)."""
    bad = (cnt != ref_cnt) & (valid > 0)[..., None]
    if not bad.any():
        return
    rnd = lambda t: t.bfloat16().float()
    o = torch.relu(rnd(torch.relu(a.unsqueeze(-3) - u.unsqueeze(-2)))
                   @ rnd(W2.float())[:, None, None]
                   + b2.float()[:, None, None, None])
    o = o.masked_fill(~(valid[..., None, :, None] > 0), -1e9)
    near = ((o - ref.unsqueeze(-2)).abs() <= atol).sum(-2)
    assert ((cnt >= 1) & (cnt <= near))[bad].all()


@pytest.mark.parametrize("R,S,N,B,dtype", [
    (1, 64, 64, 8, torch.float32), (4, 32, 64, 48, torch.float32),
    (1, 64, 64, 48, torch.bfloat16)])
def test_bf16_mode_kernels_match_plain(cuda, R, S, N, B, dtype):
    """K1 and K2 with ``bf16=True`` against their plain versions in the
    same mode (K2 on its own selection; K1's cnt equal but at near-ties),
    counted apart from the exact mode's launches; the mode moves pooled
    off the exact mode's."""
    from grouptraj_torch.ops.cuda_pool import pool_core_bwd, pool_core_fwd
    from grouptraj_torch.ops.pooling import pool_core, pool_core_bwd_plain
    a, u, W2, b2, valid = _inputs(cuda, R, S, N, B, seed=N + B, dtype=dtype)
    counts = lambda: (pool_core_fwd.launches, pool_core_fwd.launches_bf16,
                      pool_core_bwd.launches, pool_core_bwd.launches_bf16)
    before = counts()
    pooled, cnt = pool_core_fwd(a, u, W2, b2, valid, bf16=True)
    ref, ref_cnt = pool_core(a, u, W2, b2, valid, bf16=True)
    rows = valid > 0
    assert (pooled - ref)[rows].abs().max().item() <= 1e-5 * max(
        1.0, ref[rows].abs().max().item())
    _assert_cnt_or_near_tie(cnt, ref, ref_cnt, a, u, W2, b2, valid)
    assert (pooled - pool_core_fwd(a, u, W2, b2, valid)[0])[rows].abs() \
        .max().item() > 0
    if dtype == torch.float32:
        dpool = torch.randn_like(pooled)
        dbg = {}
        out = pool_core_bwd(a, u, W2, b2, valid, pooled, cnt, dpool,
                            debug=dbg, bf16=True)
        torch.cuda.synchronize()
        assert torch.equal(dbg["recount"][rows], cnt[rows])
        ref = pool_core_bwd_plain(a, u, W2, b2, valid, pooled, cnt, dpool,
                                  ties=dbg["ties"], bf16=True)
        for x, r in zip(out, ref):
            assert (x - r).abs().max().item() <= 1e-5 * max(
                1.0, r.abs().max().item())
    bwd = int(dtype == torch.float32)
    assert counts() == (before[0] + 1, before[1] + 1, before[2],
                        before[3] + bwd)


def test_bf16_mode_bit_equal_on_quantized_inputs(cuda):
    """Inputs exact in bfloat16 whose products and sums float32 adds
    exactly: K1 in the bf16 mode equals its plain version bit for bit, and
    K2 on the plain version's own selection (the cotangent's shares among
    ties exact too) equals the plain backward bit for bit."""
    from grouptraj_torch.ops.cuda_pool import pool_core_bwd, pool_core_fwd
    from grouptraj_torch.ops.pooling import pool_core, pool_core_bwd_plain
    g = torch.Generator().manual_seed(3)
    q = lambda lo, hi, den, *s: (torch.randint(lo, hi + 1, s, generator=g)
                                 / den).to(cuda)
    S, N, B = 8, 40, 8
    a, u = q(-4, 4, 2, 1, S, N, 512), q(-4, 4, 2, 1, S, N, 512)
    W2, b2 = q(-1, 1, 4, 1, 512, B), q(-4, 4, 2, 1, B)
    valid = torch.ones(1, S, N, device=cuda)
    pooled, cnt = pool_core_fwd(a, u, W2, b2, valid, bf16=True)
    ref, ref_cnt = pool_core(a, u, W2, b2, valid, bf16=True)
    assert torch.equal(pooled, ref) and torch.equal(cnt, ref_cnt)
    assert ((cnt > 1) & (pooled > 0)).any()
    dpool = q(-8, 8, 8, 1, S, N, B) * cnt.clamp(min=1)
    out = pool_core_bwd(a, u, W2, b2, valid, pooled, cnt, dpool, bf16=True)
    ref = pool_core_bwd_plain(a, u, W2, b2, valid, ref, ref_cnt, dpool,
                              bf16=True)
    for x, r in zip(out, ref):
        assert torch.equal(x, r)


def test_bf16_setting_switches_the_paths(cuda):
    """Under ``default_matmul_precision("default")`` a training iteration
    (K1 x4, K2 x3) and a per-step serving call (K1 on the context and
    every decode step) launch K1/K2 in the bf16 mode only; outside it the
    exact mode only."""
    from grouptraj_torch.config import ModelConfig, TrainConfig
    from grouptraj_torch.ops.cuda_pool import pool_core_bwd, pool_core_fwd
    from grouptraj_torch.ops.precision import default_matmul_precision
    from grouptraj_torch.serve import Predictor
    from grouptraj_torch.train.device_data import synthetic_device_data
    from grouptraj_torch.train.steps import init_train_state, train_iterations
    counts = lambda: (pool_core_fwd.launches, pool_core_fwd.launches_bf16,
                      pool_core_bwd.launches, pool_core_bwd.launches_bf16)
    cfg = ModelConfig()
    tcfg = dataclasses.replace(TrainConfig(), best_k=4)
    data = synthetic_device_data(32, 16, device=cuda)
    idx = torch.arange(16, device=cuda).reshape(1, 2, 8)
    for name, bf16 in (("default", True), ("highest", False)):
        state = init_train_state(cfg, tcfg, device=cuda)
        before = counts()
        with default_matmul_precision(name):
            out = train_iterations(state, data, idx, cfg, tcfg,
                                   generator=torch.Generator(cuda)
                                   .manual_seed(0))
        fwd, bwd = (0, 4) if bf16 else (4, 0), (0, 3) if bf16 else (3, 0)
        assert counts() == (before[0] + fwd[0], before[1] + fwd[1],
                            before[2] + bwd[0], before[3] + bwd[1]), name
        assert all(torch.isfinite(v).all() for v in out.values())
    pet = ModelConfig(pool_every_timestep=True)
    g = init_train_state(pet, tcfg, device=cuda).g
    p = Predictor({k: v.detach() for k, v in g.state_dict().items()}, pet,
                  num_samples=4, param_dtype=None, device=cuda)
    rng = np.random.default_rng(0)
    scenes = [np.cumsum(rng.normal(0, 0.4, (n, 8, 2)), 1).astype(np.float32)
              for n in (3, 9, 14)]
    before = counts()
    with default_matmul_precision("default"):
        out = p.predict_batch(scenes)
    after = counts()
    assert after[0] == before[0] and after[1] >= before[1] + 1 + pet.pred_len
    assert all(np.isfinite(o).all() for o in out)
