"""The port's CUDA kernels on the card: K1 (csrc/pool_core_fwd.cu) and K2
(csrc/pool_core_bwd.cu) against their plain PyTorch versions, the
Predictor's kernel path against its plain-pool path, one training
iteration through both kernels against the plain pool; K3
(csrc/lstm_fused_fwd.cu) and K4 (csrc/lstm_fused_bwd.cu) against their
plain versions, two K4 calls that give equal bits, K4 on misaligned
views, and a training iteration with ``lstm_impl='fused'`` against
``'scan'``; K5 (csrc/lstm_proj_fwd.cu) and K6 (csrc/lstm_proj_bwd.cu)
against their plain versions, and a training iteration with
``lstm_impl='pallas'`` against ``'scan'``. Marked ``cuda``; each test skips
without a CUDA device.
This file imports no JAX, so on a machine without it run

    python -m pytest --noconftest -q tests/test_torch_cuda.py

Tolerances: pooled atol 1e-4 (float32 sums of K=512 products in another
order); ``cnt`` exact (ties come from equal inputs); positions 1e-3 m
(the pool's rounding carried through the GAT and 12 decoder steps); K2's
da/du 1e-5 and dW2/db2 1e-4 relative to the largest reference entry, given
the kernel's own tie selection (see chip_smoke.py:check_bwd for why); the
training iteration's losses 1e-4 relative; K3's outputs 1e-5 absolute and
K4's gradients 1e-4 of each tensor's largest entry (float32 sums of H ≤ 48
products in another order, accurate expf/tanhf on both sides), and the same
for K5 and K6.
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

def _lstm_case(cuda, T, B, H, with_gx, seed):
    g = torch.Generator().manual_seed(seed)
    r = lambda *s: torch.randn(*s, generator=g).to(cuda)
    w, h0, c0 = r(H, 4 * H) * 0.3, r(B, H), r(B, H)
    gx = r(T, B, 4 * H) if with_gx else None
    b = None if with_gx else r(4 * H) * 0.1
    return w, h0, c0, gx, b, (r(T, B, H), r(B, H), r(B, H))


@pytest.mark.parametrize("T,B,H,with_gx", [
    (8, 100, 32, True), (5, 9, 8, True), (20, 40, 48, True),
    (11, 70, 32, False), (7, 9, 16, False), (1, 1, 32, True),
    (3, 33, 64, False)])
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


@pytest.mark.parametrize("T,B,H,with_gx", [
    (8, 50, 32, True), (6, 16, 16, True), (20, 40, 48, True),
    (11, 24, 32, False), (7, 9, 8, False), (1, 1, 48, True),
    (20, 8192, 48, True), (11, 8192, 32, False), (3, 4097, 8, True),
    (4, 40, 64, True), (3, 33, 64, False)])
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

    def shifted(t):
        buf = torch.empty(t.numel() + 1, device=cuda)
        view = buf[1:].view(t.shape)
        view.copy_(t)
        assert view.data_ptr() % 16 != 0
        return view

    args = [shifted(t) for t in (h0, c0, ys, gates, cs, dys)]
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
    with pytest.raises(ValueError):
        CL.lstm_fused_fwd(torch.zeros(12, 48, device=cuda),
                          torch.zeros(3, 12, device=cuda),
                          torch.zeros(3, 12, device=cuda),
                          b=torch.zeros(48, device=cuda), T=2)


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
    w_ih, w_hh, b = r(D, 4 * H) * 0.3, r(H, 4 * H) * 0.3, r(4 * H) * 0.1
    return w_ih, w_hh, b, r(T, B, D), r(B, H), r(B, H), (r(T, B, H),
                                                          r(B, H), r(B, H))


@pytest.mark.parametrize("T,B,D,H", [(8, 100, 16, 32), (20, 70, 16, 48),
                                     (5, 9, 4, 8), (6, 40, 8, 64),
                                     (20, 8192, 16, 48), (3, 4097, 4, 8),
                                     (4, 33, 16, 64)])
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
