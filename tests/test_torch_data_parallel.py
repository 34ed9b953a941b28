"""The port's data parallelism over scenes on the CPU: two gloo ranks,
spawned by ``grouptraj_torch.parallel.data_parallel.spawn`` (a ``file://``
store under ``tmp_path``), each importing torch and the port only.

One d-step + g-step on 2 ranks against ``grouptraj``'s steps on a 2-device
mesh (``make_mesh(2)``, ``replicate_state``, ``shard_arrays``: GSPMD's
global reductions) and against the port in one process, from one JAX init
(test_torch_options.py's ``_jax_state``), S=4 scenes (2 a rank), N=6,
best_k 3, narrow widths, JAX's draws injected at the global batch's shapes
and sliced by each rank: the noise and label as test_torch_steps.py takes
them, dropout1's keep-masks recorded as test_torch_options.py records them.
Tolerances as those files': losses 1e-5 relative; gradients 1e-6 of the
network's largest (3e-5 with batch_norm: ROADMAP.md §3, BatchNorm's
conditioning); weights after the step test_torch_options.py's
``_assert_params`` (1e-6 plus what the gradient bound can move a first Adam
step). The 2-rank port against the 1-process port: the same (with
batch_norm too: the two sum the statistics and gradients in another order,
which the statistics amplify; 1.0e-6 of D's largest gradient at this
init), and so are batch_norm with dropout1 and dropout (:data:`EXTRA`,
numpy's keep-masks).

``train()`` with ``num_devices=2`` over 2 scene-size buckets with a
checkpoint event and a resume, against the port's one-process ``train()``
(the one-process ``train()`` is held against grouptraj's in
test_torch_loop.py): both draw from a generator seeded alike, each rank at
the global batch's shapes (a ``Draws`` cannot know a dispatch's bucket
width ahead of it). Histories 1e-5 of their largest; weights 1e-6, but
where the gradient is rounding noise (its RMS, the one-process Adam's
second moment, under 1e-6 of its network's largest: the GAT attention
vectors and the inter-group output weights on these small groups), which
Adam's normalisation turns into steps of up to lr with either sign, lr an
iteration (0.52 lr after 4 iterations, the worst seen); Adam moments 1e-6
of their optimizer's largest; only rank 0 writes files. Every weight with
a real gradient agrees within 1e-7. The same spawn runs the training CLI
as torchrun starts it. ``dryrun_data_parallel(2)`` (stages 1-3 single-seed
iterations, stage 4 a sweep's) runs in
tests/test_torch_data_parallel_many.py.
"""

import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import test_torch_options as O
from grouptraj.models.generator import generator_forward as jax_forward
from grouptraj.models.generator import sample_noises as jax_sample_noises
from grouptraj.parallel.data_parallel import synthetic_batch
from grouptraj.parallel.mesh import make_mesh, replicate_state, shard_arrays
from grouptraj_torch.compat import discriminator_state, generator_state
from grouptraj_torch.config import ModelConfig, TrainConfig
from grouptraj_torch.data.synthetic import write_scene_files
from grouptraj_torch.models.discriminator import TrajectoryDiscriminator
from grouptraj_torch.models.generator import TrajectoryGenerator
from grouptraj_torch.parallel import data_parallel as DP
from grouptraj_torch.parallel.mesh import check_backend, get_dp_group
from grouptraj_torch.train import loop as LOOP
from grouptraj_torch.train import multi as MULTI
from grouptraj_torch.train import steps as TS

WORLD = 2
CONFIGS = {"gat": {}, "batch_norm": dict(batch_norm=True),
           "dropout1": dict(dropout1=0.2)}
S, N = O.S, O.N
# models held on 2 ranks against one process only, each built on a config
# above: batch_norm with dropout1 (the per-sample g-step sums BN's
# statistics over the ranks under vmap) and dropout (D's stacked real |
# fake call slices its keep-masks in two blocks)
EXTRA = {"bn_dropout1": ("batch_norm", dict(dropout1=0.2)),
         "dropout": ("gat", dict(dropout=0.2))}


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """Many small CPU ops: one torch thread a process keeps the workers of
    a parallel test run from spinning against each other."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _draws(jcfg, state, batch):
    """One iteration's draws under the key splits of build_d_step /
    build_g_step (test_torch_options.py's ``_references`` without its
    eval-mode outputs): the d-step's noise, label and, with dropout1,
    keep-masks; the g-step's noises, label and, with dropout1, per-sample
    masks and D's masks."""
    k_gen, k_dlabel, k_ddisc = jax.random.split(O.KEYS["d"], 3)
    k_glabel, k_samples, k_gdisc = jax.random.split(O.KEYS["g"], 3)
    samples = jax.random.split(k_samples, O.TRAIN["best_k"])
    label = lambda k: float(jax.random.uniform(k, (), minval=0.7,
                                               maxval=1.2))
    d = dict(noise=O._t(jax_sample_noises(jcfg, k_gen[None], S, N,
                                          np.float32)[0]),
             label=label(k_dlabel))
    g = dict(noises=O._t(jax_sample_noises(jcfg, samples, S, N,
                                           np.float32)),
             label=label(k_glabel))
    if not jcfg.dropout1:
        return d, g
    To = jcfg.obs_len + jcfg.pred_len
    traj = jnp.zeros((S, N, To, 2), jnp.float32)

    @O._jit_for(jcfg)
    def run(g_params, d_params, b):
        with O._recording() as d_masks:
            ctx = O.jax_context(g_params, jcfg, b["obs"], b["obs_rel"],
                                b["group"], b["valid"], k_gen)
            O.jax_generator_sample(g_params, jcfg, ctx, b["obs"],
                                   b["obs_rel"], b["group"], b["valid"],
                                   k_gen)
            O.jax_disc(d_params, jcfg, jnp.concatenate([traj] * 2),
                       jnp.concatenate([traj] * 2),
                       jnp.concatenate([b["valid"]] * 2), k_ddisc)

        def sample_masks(k):
            with O._recording() as ms:
                jax_forward(g_params, jcfg, b["obs"], b["obs_rel"],
                            b["group"], b["valid"], k)
            return ms

        with O._recording() as gd_masks:
            O.jax_disc(d_params, jcfg, traj, traj, b["valid"], k_gdisc)
        return d_masks, jax.vmap(sample_masks)(samples), gd_masks

    d["masks"], stacked, g["d_masks"] = jax.tree_util.tree_map(
        np.asarray, run(state.g_params, state.d_params, batch))
    assert d["masks"]
    g["sample_masks"] = [[m[i] for m in stacked]     # per mask [best_k, ...]
                         for i in range(O.TRAIN["best_k"])]
    return d, g


def _port(cfg, job):
    g, d = TrajectoryGenerator(cfg), TrajectoryDiscriminator(cfg)
    g.load_state_dict(job.g_state)
    d.load_state_dict(job.d_state)
    return TS.train_state_from_modules(g, d, O.TCFG)


def _loaded(module, params):
    """A copy of ``module`` holding ``params`` (a rank's weights)."""
    m = type(module)(module.cfg)
    m.load_state_dict(params)
    return m


def _ranks(tmp_path, fn, job):
    out = tmp_path / "ranks"
    out.mkdir()
    DP.spawn(fn, WORLD, "gloo", init_file=str(tmp_path / "store"),
             args=(job, str(out)))
    ranks = DP.load_results(str(out), WORLD)
    assert [r["foreign_modules"] for r in ranks] == [[]] * WORLD
    return ranks


def _hold(port, rank, ref, rtol, what):
    """A rank's (or a port run's) gradients, losses and weights against
    ``ref`` = (losses, (D grads, G grads), (D, G) after the steps)."""
    losses, (d_grads, g_grads), (d_ref, g_ref) = ref
    bounds = {}
    for part, module, grads in (("d", port.d, d_grads), ("g", port.g,
                                                         g_grads)):
        names = [n for n, _ in module.named_parameters()]
        bounds[part] = O._assert_grads(
            module, [rank[f"{part}_grads"][n] for n in names], grads,
            f"{what} {part}", rtol)
    assert set(rank["losses"]) == set(losses)
    for k, r in losses.items():
        np.testing.assert_allclose(rank["losses"][k], r, rtol=1e-5,
                                   atol=1e-7, err_msg=f"{what} {k}")
    for part, module, ref_w, grads, lr in (
            ("d", port.d, d_ref, d_grads, O.TCFG.d_learning_rate),
            ("g", port.g, g_ref, g_grads, O.TCFG.g_learning_rate)):
        O._assert_params(_loaded(module, rank[part]), ref_w, grads,
                         bounds[part], lr, f"{what} {part}")


def _numpy_draws(job, seed):
    """The JAX draws of ``job`` with keep-masks drawn by numpy at the
    shapes the port's steps ask for (``steps.d_mask_shapes``,
    ``sample_mask_shapes``, ``disc_mask_shapes``), for a model no JAX test
    here runs."""
    r = np.random.default_rng(seed)
    masks = lambda shapes: [r.random(shape) < keep for shape, keep in shapes]
    cfg = job.cfg
    d = dict(job.d_draw, masks=masks(TS.d_mask_shapes(cfg, S, N)))
    g = dict(job.g_draw, d_masks=masks(TS.disc_mask_shapes(cfg, S, N)),
             sample_masks=[masks(TS.sample_mask_shapes(cfg, S, N))
                           for _ in range(O.TRAIN["best_k"])])
    return dataclasses.replace(job, d_draw=d, g_draw=g)


@pytest.fixture(scope="module")
def step_runs(tmp_path_factory):
    """Per config: the JAX state, the batch and its draws, and one
    d-step + g-step of the port on 2 ranks (one spawn for all configs;
    with numpy's keep-masks also the models of :data:`EXTRA`)."""
    runs, jobs = {}, {}
    for name, option in CONFIGS.items():
        changes = dict(O.NARROW, **option)
        jcfg, cfg = O.JaxModelConfig(**changes), ModelConfig(**changes)
        state = O._jax_state(jcfg, cfg, 0)
        state.d_params["real_classifier"]["layers"][-1]["linear"]["b"] += 1.0
        batch = synthetic_batch(S, N, jcfg.obs_len, jcfg.pred_len, seed=5)
        jobs[name] = DP.StepsJob(
            cfg, O.TCFG,
            generator_state(O._np_state(state.g_params, "generator")),
            discriminator_state(O._np_state(state.d_params,
                                            "discriminator")),
            {k: np.asarray(v) for k, v in batch.items()},
            *_draws(jcfg, state, batch))
        runs[name] = (jcfg, state, batch)
    for name, (base, option) in EXTRA.items():
        jobs[name] = _numpy_draws(dataclasses.replace(
            jobs[base], cfg=dataclasses.replace(jobs[base].cfg, **option)),
            7)
    ranks = _ranks(tmp_path_factory.mktemp("steps"), DP.steps_rank, jobs)
    return {name: (*runs.get(name, (None,) * 3), jobs[name],
                   [r[name] for r in ranks]) for name in jobs}


def _one_process(job):
    """The port's d-step + g-step in this process (no group) -> (losses,
    (D grads, G grads), (D, G) after the steps), as _hold reads them."""
    cfg, port = job.cfg, _port(job.cfg, job)
    b = {k: O._t(v) for k, v in job.batch.items()}
    d_grads = TS.d_gradients(port, b, cfg, O.TCFG, **job.d_draw)[1]
    losses = TS.d_step(port, b, cfg, O.TCFG, **job.d_draw)
    g_grads = TS.g_gradients(port, b, cfg, O.TCFG, **job.g_draw)[1]
    losses.update(TS.g_step(port, b, cfg, O.TCFG, **job.g_draw))
    assert get_dp_group() is None
    grads = tuple({n: g.numpy() for (n, _), g in zip(m.named_parameters(),
                                                     gs)}
                  for m, gs in ((port.d, d_grads), (port.g, g_grads)))
    return ({k: float(v) for k, v in losses.items()}, grads,
            tuple({k: v.numpy() for k, v in m.state_dict().items()}
                  for m in (port.d, port.g)))


def _ranks_agree(ranks):
    for key in ("d_grads", "g_grads", "d", "g"):
        for k, v in ranks[0][key].items():
            assert torch.equal(v, ranks[1][key][k]), (key, k)
    assert ranks[0]["losses"] == ranks[1]["losses"]


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_dp_steps_match_grouptraj_mesh(name, step_runs, monkeypatch):
    """One d-step + g-step on 2 gloo ranks against grouptraj's steps on a
    2-device mesh with JAX's draws injected, and against the port in one
    process; the ranks agree with each other bit for bit. The models of
    :data:`EXTRA` built on this one: on 2 ranks against one process."""
    jcfg, state, batch, job, ranks = step_runs[name]
    rtol = 3e-5 if job.cfg.batch_norm else 1e-6
    mesh = make_mesh(WORLD)
    ref = O._jax_iteration(jcfg, replicate_state(state, mesh),
                           shard_arrays(batch, mesh), monkeypatch)
    assert ref[0]["norm_d"] > 0 and ref[0]["norm_g"] > 0
    _ranks_agree(ranks)
    fresh = _port(job.cfg, job)
    _hold(fresh, ranks[0], ref, rtol, f"{name} 2 ranks vs grouptraj mesh")
    _hold(fresh, ranks[0], _one_process(job), rtol,
          f"{name} 2 ranks vs 1 process")
    for extra in (e for e, (base, _) in EXTRA.items() if base == name):
        *_, job, ranks = step_runs[extra]
        _ranks_agree(ranks)
        _hold(_port(job.cfg, job), ranks[0], _one_process(job), rtol,
              f"{extra} 2 ranks vs 1 process")


TRAIN_LR = {"g": TrainConfig().g_learning_rate,
            "d": TrainConfig().d_learning_rate}
TRAIN = dict(dataset_name="synth", batch_size=4, best_k=3, num_epochs=0,
             n_buckets=2, steps_per_dispatch=2, print_every=1,
             checkpoint_every=2, num_samples_check=40, checkpoint_name="ck",
             bf16_nograd=False, seed=5)


def _train_runs(cfg, tcfg, runs, device="cpu"):
    """The port's one-process train() runs, as DP.train_rank records them."""
    out = []
    for iters, restore in runs:
        ckpt, st = LOOP.train(cfg, dataclasses.replace(
            tcfg, num_iterations=iters, restore_from_checkpoint=restore),
            device=device, return_state=True)
        adam = {f"{p}.{n}.{k}": v for p, m, o in (("g", st.g, st.g_opt),
                                                  ("d", st.d, st.d_opt))
                for n, q in m.named_parameters()
                for k, v in o.state[q].items()}
        out.append({"ckpt": {k: ckpt[k] for k in DP.HISTORY_KEYS},
                    "g": dict(st.g.named_parameters()),
                    "d": dict(st.d.named_parameters()), "adam": adam})
    return out


def _flat(history):
    """A checkpoint's histories as {name: float array} (counters apart)."""
    out = {}
    for k in ("D_losses", "G_losses", "metrics_val", "metrics_train"):
        for name, v in history[k].items():
            out[f"{k}.{name}"] = np.asarray(v, np.float64)
    for k in ("norm_d", "norm_g"):
        out[k] = np.asarray(history[k], np.float64)
    return out


def test_dp_train_matches_one_process(tmp_path, monkeypatch):
    """train() with num_devices=2 over 2 buckets, a checkpoint at t=2 and a
    resume to t=4 from rank 0's file, against one process; only rank 0
    writes files. In the same spawn the training CLI as torchrun starts it
    (``--num_devices 2 --dist_backend gloo``) trains 2 iterations."""
    root = tmp_path / "data"
    write_scene_files(str(root / "synth" / "train"), n_files=1, frames=70,
                      max_peds=12, seed=0)
    write_scene_files(str(root / "synth" / "val"), n_files=1, frames=30,
                      max_peds=12, seed=1)
    monkeypatch.setenv("GROUPTRAJ_DATA_DIR", str(root))
    cfg = ModelConfig(**O.NARROW)
    runs = ((2, False), (4, True))
    one = _train_runs(cfg, TrainConfig(**TRAIN,
                                       output_dir=str(tmp_path / "one")),
                      runs)
    tcfg = TrainConfig(**TRAIN, output_dir=str(tmp_path / "dp"),
                       num_devices=WORLD)
    argv = ["--dataset_name", "synth", "--device", "cpu", "--num_devices",
            str(WORLD), "--dist_backend", "gloo", "--num_epochs", "0",
            "--num_iterations", "2", "--checkpoint_every", "2",
            "--steps_per_dispatch", "2", "--n_buckets", "2",
            "--output_dir", str(tmp_path / "cli"), "--checkpoint_name",
            "cli"] + [f"--{k}={v}" for k, v in dict(
                batch_size=4, best_k=3, print_every=1, num_samples_check=40,
                embedding_dim=8, encoder_h_dim_g=16, decoder_h_dim_g=16,
                noise_dim=4, bottleneck_dim=4, hidden_units=12,
                encoder_h_dim_d=12, mlp_dim=16).items()]
    outs = {k: tmp_path / f"ranks_{k}" for k in ("train", "cli")}
    for d in outs.values():
        d.mkdir()
    DP.spawn(DP.each_rank, WORLD, "gloo", init_file=str(tmp_path / "store"),
             args=([(DP.train_rank, dict(cfg=cfg, tcfg=tcfg,
                                         data_dir=str(root), runs=runs),
                     str(outs["train"])),
                    (DP.cli_rank, dict(argv=argv, data_dir=str(root)),
                     str(outs["cli"]))],))
    ranks, cli_ranks = (DP.load_results(str(d), WORLD)
                        for d in outs.values())
    assert [r["foreign_modules"] for r in ranks + cli_ranks] == [[]] * 4
    # each rank trains into <output_dir>/rank<r>: rank 0's files, no other
    assert os.listdir(tmp_path / "dp") == ["rank0"]
    for where, name in ((tmp_path / "dp" / "rank0", "ck"),
                        (tmp_path / "cli", "cli")):
        assert sorted(os.listdir(where)) == [f"{name}_{s}_model.pt"
                                             for s in ("no", "with")]
    cli0, cli1 = (r["ckpt"] for r in cli_ranks)
    assert cli0 == cli1 and cli0["counters"]["t"] == 2
    assert all(np.isfinite(v).all() for v in _flat(cli0).values())
    for r, rank in enumerate(ranks):
        for run, ref in zip(rank["runs"], one):
            got, want = run["ckpt"], ref["ckpt"]
            for k in ("losses_ts", "sample_ts", "restore_ts", "counters",
                      "best_t", "best_t_nl"):
                assert got[k] == want[k], (r, k)
            g, w = _flat(got), _flat(want)
            assert set(g) == set(w)
            for k, v in w.items():
                assert np.abs(g[k] - v).max() <= 1e-5 * np.abs(v).max(), \
                    (r, k, g[k], v)
            iters = want["counters"]["t"]
            for part, lr in (("g", TRAIN_LR["g"]), ("d", TRAIN_LR["d"])):
                rms = {n: ref["adam"][f"{part}.{n}.exp_avg_sq"].sqrt()
                       for n in ref[part]}
                top = max(v.max() for v in rms.values())
                for name, v in ref[part].items():
                    tol = torch.where(rms[name] < 1e-6 * top, lr * iters,
                                      1e-6)
                    err = (run[part][name] - v.detach()).abs()
                    assert (err <= tol).all(), (r, part, name,
                                                err.max() / lr)
            for p in ("g.", "d."):
                keys = [k for k in ref["adam"] if k.startswith(p)
                        and not k.endswith(".step")]
                top = max(ref["adam"][k].abs().max().item() for k in keys)
                for k in keys:
                    err = (run["adam"][k] - ref["adam"][k]).abs().max()
                    assert err <= 1e-6 * top, (r, k, err / top)
                assert all(torch.equal(run["adam"][k], ref["adam"][k])
                           for k in ref["adam"] if k.startswith(p)
                           and k.endswith(".step"))


@pytest.mark.parametrize("case", ["loop", "nccl", "train_many"])
def test_dp_refusals(case, tmp_path, monkeypatch):
    """A batch the ranks cannot split; num_devices without a group of that
    size (the launch recipe in the message), num_devices=0 on several cards
    among them (every visible card, as JAX's 0; 1 on the CPU); nccl asked for two ranks on
    one card, refused before any process or group is made; train_many
    with num_devices=2 without a group, refused as train() refuses it
    (the sweep CLI's launch recipe in the message)."""
    cfg = ModelConfig(**O.NARROW)
    tcfg = TrainConfig(**TRAIN, output_dir=str(tmp_path))
    if case == "loop":
        with pytest.raises(ValueError, match="must be divisible by"):
            LOOP.train(cfg, dataclasses.replace(tcfg, batch_size=3,
                                                num_devices=WORLD),
                       device="cpu")
        with pytest.raises(ValueError, match=r"torchrun --nproc_per_node 2"):
            LOOP.train(cfg, dataclasses.replace(tcfg, num_devices=WORLD),
                       device="cpu")
        monkeypatch.setattr(torch.cuda, "device_count", lambda: 2)
        every = dataclasses.replace(tcfg, num_devices=0)
        assert LOOP.num_devices(every, torch.device("cpu")) == (1, None)
        with pytest.raises(ValueError, match=r"num_devices=0 \(every visible "
                                             r"card: 2\).*torchrun"):
            LOOP._check_devices(every, torch.device("cuda"))
        assert get_dp_group() is None
    elif case == "nccl":
        with pytest.raises(ValueError, match="NCCL refuses two ranks on one "
                                             "device"):
            DP.spawn(DP.steps_rank, WORLD, "nccl",
                     device_of_rank=lambda r: "cuda:0",
                     init_file=str(tmp_path / "store"))
        assert not (tmp_path / "store").exists()
        check_backend("nccl", ["cuda:0", "cuda:1"])
        with pytest.raises(ValueError, match="CUDA devices"):
            check_backend("nccl", ["cpu", "cpu"])
    else:
        with pytest.raises(ValueError, match=r"torchrun --nproc_per_node 2 "
                                             r"-m grouptraj_torch\.train\."
                                             r"cli_many"):
            MULTI.train_many(cfg, dataclasses.replace(tcfg,
                                                      num_devices=WORLD),
                             [5, 6], device="cpu")
        assert get_dp_group() is None
