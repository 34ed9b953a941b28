"""The port's multi-seed sweeps over data-parallel scene shards on the CPU
(``train/multi.py:train_many`` with ``num_devices=2``): the seed vmap
outside, two gloo ranks inside, each holding both seeds and running its
half of every batch's scenes, spawned once for all cases by
``grouptraj_torch.parallel.data_parallel.spawn`` (``each_rank``), each
importing torch and the port only.

- (a) One d-step + g-step of 2 seeds on 2 ranks (``d_step_many`` /
  ``g_step_many`` from ``data_parallel.sweep_steps_rank``) against
  ``jax.vmap`` over the seeds of grouptraj's steps with the batch sharded
  on a 2-device mesh (``make_mesh(2)``, ``replicate_state``,
  ``shard_arrays``), every draw JAX's, per seed at the global batch's
  shapes (as tests/test_torch_multi_dropout.py and
  tests/test_torch_data_parallel.py take them), and against the port's
  sweep in one process; models ``gat``, ``batch_norm`` and ``dropout1``
  (the per-sample vmap nested in the seed vmap, its keep-masks sliced).
  Built on the ``gat`` case with numpy's keep-masks, ``dropout`` (D's
  stacked real | fake call cutting its keep-masks in two blocks inside the
  seed vmap) on the ranks against the port's sweep in one process.
  Narrow widths (tests/test_torch_options.py's), S=4 scenes (2 a rank),
  N=6, best_k 3. Tolerances as those files': losses 1e-5 relative (1e-6
  absolute near 0), gradients 1e-6 of the network's largest (3e-5 with
  batch_norm), weights by ``test_torch_options._assert_params``.
- (b) ``train_many(num_devices=2)`` over 2 scene-size buckets with a
  checkpoint event and a resume from rank 0's sweep directory, against the
  port's one-process ``train_many`` (held against grouptraj's in
  tests/test_torch_multi.py): histories 1e-5 of their largest; weights
  1e-6, but lr an iteration where the gradient is rounding noise (its RMS,
  the one-process Adam's second moment, under 1e-6 of its network's
  largest), which Adam turns into steps of up to lr; Adam moments 1e-6 of
  their optimizer's largest; only rank 0 writes ``s<seed>/``; every
  replica's generator ends where one process leaves it, on both ranks.
- (c) ``python -m grouptraj_torch.train.cli_many`` as torchrun starts it.
- (d) ``dryrun_data_parallel(2)`` (the whole dry run: this file runs it
  for the suite), whose stage 4 runs a 2-seed sweep on the ranks at two
  bucket widths against one process.
- (e) The mask-shape dry runs give one process's shapes whatever group is
  in force, so their cached answers cross no group boundary, and a rank's
  sweep draws its keep-masks at the global batch's shapes.
"""

import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import test_torch_data_parallel as TDP
import test_torch_multi_dropout as MD
import test_torch_options as O
from grouptraj.models.generator import sample_noises as jax_sample_noises
from grouptraj.parallel.data_parallel import synthetic_batch
from grouptraj.parallel.mesh import make_mesh, replicate_state, shard_arrays
from grouptraj.train.steps import build_d_step, build_g_step
from grouptraj_torch.compat import discriminator_state, generator_state
from grouptraj_torch.config import ModelConfig, TrainConfig
from grouptraj_torch.data.synthetic import write_scene_files
from grouptraj_torch.models.discriminator import TrajectoryDiscriminator
from grouptraj_torch.models.generator import TrajectoryGenerator
from grouptraj_torch.parallel import data_parallel as DP
from grouptraj_torch.parallel.mesh import DPGroup, get_dp_group, set_dp_group
from grouptraj_torch.train import multi as MULTI
from grouptraj_torch.train import steps as TS

WORLD = 2
SEEDS = [5, 6]
CONFIGS = {"gat": {}, "batch_norm": dict(batch_norm=True),
           "dropout1": dict(dropout1=0.2)}
# built on a case of CONFIGS with numpy's keep-masks, held against the
# port's sweep in one process: dropout (D's stacked real | fake call slices
# its keep-masks in two blocks)
EXTRA = {"dropout": ("gat", dict(dropout=0.2))}
S, N = O.S, O.N
BEST_K = O.TCFG.best_k
RUNS = ((2, False), (4, True))            # (b): a checkpoint, then a resume


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """Many small CPU ops: one torch thread a process keeps the workers of
    a parallel test run from spinning against each other."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _stack(trees):
    return jax.tree_util.tree_map(lambda *x: jnp.stack(x), *trees)


def _jax_reference(jcfg, cfg, batch):
    """grouptraj's side of (a) for one model, one compiled program over
    both seeds (``jax.vmap``) with the batch sharded on a 2-device mesh:
    each seed's state (the port's init through ``params_to_jax``, D's last
    classifier bias lifted by 1: a live discriminator), its draws under the
    key splits of build_d_step / build_g_step (noise, label, keep-masks,
    test_torch_multi_dropout.py's ``_jax_reference``) and one d-step +
    g-step with the gradients each took (test_torch_options.py's identity
    optimizer, the package's clip + Adam applied to them). -> (states,
    draws ``[2, ...]``, per seed (losses, (D grads, G grads), (D, G) after
    the steps))."""
    states = []
    for s in SEEDS:
        st = O._jax_state(jcfg, cfg, s)
        st.d_params["real_classifier"]["layers"][-1]["linear"]["b"] += 1.0
        states.append(st)
    states = _stack(states)
    To = jcfg.obs_len + jcfg.pred_len
    traj = lambda s: jnp.zeros((s, N, To, 2), jnp.float32)
    label = lambda k: jax.random.uniform(k, (), minval=0.7, maxval=1.2)
    kd = jnp.stack([jax.random.PRNGKey(100 + s) for s in SEEDS])
    kg = jnp.stack([jax.random.PRNGKey(200 + s) for s in SEEDS])

    def draws(g_params, d_params, b, kd, kg):
        k_gen, k_dlabel, k_ddisc = jax.random.split(kd, 3)
        k_glabel, k_samples, k_gdisc = jax.random.split(kg, 3)
        samples = jax.random.split(k_samples, BEST_K)
        with O._recording() as d_masks:
            ctx = O.jax_context(g_params, jcfg, b["obs"], b["obs_rel"],
                                b["group"], b["valid"], k_gen)
            O.jax_generator_sample(g_params, jcfg, ctx, b["obs"],
                                   b["obs_rel"], b["group"], b["valid"],
                                   k_gen)
            if jcfg.batch_norm:
                for k in jax.random.split(k_ddisc):
                    O.jax_disc(d_params, jcfg, traj(S), traj(S), b["valid"],
                               k)
            else:
                O.jax_disc(d_params, jcfg, traj(2 * S), traj(2 * S),
                           jnp.concatenate([b["valid"]] * 2), k_ddisc)

        def sample_masks(k):
            with O._recording() as ms:
                MD.jax_forward(g_params, jcfg, b["obs"], b["obs_rel"],
                               b["group"], b["valid"], k)
            return ms

        with O._recording() as gd_masks:
            O.jax_disc(d_params, jcfg, traj(S), traj(S), b["valid"], k_gdisc)
        return dict(
            d=dict(noise=jax_sample_noises(jcfg, k_gen[None], S, N,
                                           jnp.float32)[0],
                   label=label(k_dlabel), masks=d_masks),
            g=dict(noises=jax_sample_noises(jcfg, samples, S, N,
                                            jnp.float32),
                   label=label(k_glabel),
                   sample_masks=jax.vmap(sample_masks)(samples),
                   d_masks=gd_masks))

    g_tx, d_tx = O.JSTEPS.make_optimizers(O.JTCFG)
    apply = optax.apply_updates
    ident = optax.GradientTransformation(lambda p: optax.EmptyState(),
                                         lambda u, s, p=None: (u, s))
    mesh = make_mesh(WORLD)
    with pytest.MonkeyPatch.context() as m:
        m.setattr(O.JSTEPS, "make_optimizers", lambda tcfg: (ident, ident))
        m.setattr(O.JSTEPS.optax, "apply_updates", lambda p, u: u)
        d_step = build_d_step(jcfg, O.JTCFG)
        g_step = build_g_step(jcfg, O.JTCFG)

        def one(state, b, kd, kg):
            drawn = draws(state.g_params, state.d_params, b, kd, kg)
            out, ld = d_step(state, b, kd)
            d_grads = out.d_params
            upd, d_opt = d_tx.update(d_grads, state.d_opt, state.d_params)
            state = state._replace(d_params=apply(state.d_params, upd),
                                   d_opt=d_opt)
            out, lg = g_step(state, b, kg)
            g_grads = out.g_params
            upd, _ = g_tx.update(g_grads, state.g_opt, state.g_params)
            return drawn, ({**ld, **lg}, d_grads, g_grads, state.d_params,
                           apply(state.g_params, upd))

        drawn, (losses, d_grads, g_grads, d_params, g_params) = (
            jax.tree_util.tree_map(np.asarray, O._jit_for(jcfg)(jax.vmap(
                one, in_axes=(0, None, 0, 0)))(
                    replicate_state(states, mesh), shard_arrays(batch, mesh),
                    kd, kg)))
    seed = lambda tree, i: jax.tree_util.tree_map(lambda x: x[i], tree)
    refs = [({k: float(v[i]) for k, v in losses.items()},
             (O._np_state(seed(d_grads, i), "discriminator"),
              O._np_state(seed(g_grads, i), "generator")),
             (O._np_state(seed(d_params, i), "discriminator"),
              O._np_state(seed(g_params, i), "generator")))
            for i in range(len(SEEDS))]
    return states, drawn, refs


def _steps_job(cfg, states, drawn, batch):
    """The sweep's steps job: each seed's weights and its draws, the
    g-step's per-sample masks as best_k lists."""
    seed = lambda tree, i: jax.tree_util.tree_map(lambda x: x[i], tree)
    d, g = drawn["d"], drawn["g"]
    return DP.SweepStepsJob(
        cfg, O.TCFG,
        [generator_state(O._np_state(seed(states.g_params, i), "generator"))
         for i in range(len(SEEDS))],
        [discriminator_state(O._np_state(seed(states.d_params, i),
                                         "discriminator"))
         for i in range(len(SEEDS))],
        {k: np.asarray(v) for k, v in batch.items()},
        [dict(noise=d["noise"][i], label=float(d["label"][i]),
              masks=[m[i] for m in d["masks"]]) for i in range(len(SEEDS))],
        [dict(noises=g["noises"][i], label=float(g["label"][i]),
              sample_masks=[[m[i][k] for m in g["sample_masks"]]
                            for k in range(BEST_K)],
              d_masks=[m[i] for m in g["d_masks"]])
         for i in range(len(SEEDS))])


def _numpy_draws(job, option, seed):
    """``job`` for its model with ``option``, each seed's keep-masks drawn
    by numpy at the global batch's shapes that the port's steps ask for
    (``steps.d_mask_shapes``, ``sample_mask_shapes``,
    ``disc_mask_shapes``)."""
    cfg = dataclasses.replace(job.cfg, **option)
    r = np.random.default_rng(seed)
    masks = lambda shapes: [r.random(shape) < keep for shape, keep in shapes]
    return dataclasses.replace(
        job, cfg=cfg,
        d_draws=[dict(x, masks=masks(TS.d_mask_shapes(cfg, S, N)))
                 for x in job.d_draws],
        g_draws=[dict(x, d_masks=masks(TS.disc_mask_shapes(cfg, S, N)),
                      sample_masks=[masks(TS.sample_mask_shapes(cfg, S, N))
                                    for _ in range(BEST_K)])
                 for x in job.g_draws])


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Everything the spawned ranks compute, in one spawn: (a) the sweep's
    steps for each model, (b) train_many runs with a resume, (c) the sweep
    CLI as torchrun starts it; with grouptraj's references for (a) and the
    data of (b) and (c)."""
    tmp = tmp_path_factory.mktemp("dp_many")
    refs, jobs = {}, {}
    for name, option in CONFIGS.items():
        changes = dict(O.NARROW, **option)
        jcfg, cfg = O.JaxModelConfig(**changes), ModelConfig(**changes)
        batch = synthetic_batch(S, N, jcfg.obs_len, jcfg.pred_len, seed=5)
        states, drawn, refs[name] = _jax_reference(jcfg, cfg, batch)
        if option.get("dropout1"):
            assert drawn["d"]["masks"] and drawn["g"]["sample_masks"]
        jobs[name] = _steps_job(cfg, states, drawn, batch)
    for name, (base, option) in EXTRA.items():
        jobs[name] = _numpy_draws(jobs[base], option, 7)
        assert jobs[name].d_draws[0]["masks"]

    root = tmp / "data"
    write_scene_files(str(root / "synth" / "train"), n_files=1, frames=70,
                      max_peds=12, seed=0)
    write_scene_files(str(root / "synth" / "val"), n_files=1, frames=30,
                      max_peds=12, seed=1)
    cfg = ModelConfig(**O.NARROW)
    sweep = dict(cfg=cfg, seeds=SEEDS, data_dir=str(root), runs=RUNS,
                 tcfg=TrainConfig(**TDP.TRAIN, output_dir=str(tmp / "dp"),
                                  num_devices=WORLD))
    argv = ["--seeds", ",".join(map(str, SEEDS)), "--dataset_name", "synth",
            "--device", "cpu", "--num_devices", str(WORLD), "--dist_backend",
            "gloo", "--num_epochs", "0", "--num_iterations", "2",
            "--checkpoint_every", "2", "--steps_per_dispatch", "2",
            "--n_buckets", "2", "--output_dir", str(tmp / "cli"),
            "--checkpoint_name", "cli"] + [f"--{k}={v}" for k, v in dict(
                batch_size=4, best_k=3, print_every=1, num_samples_check=40,
                embedding_dim=8, encoder_h_dim_g=16, decoder_h_dim_g=16,
                noise_dim=4, bottleneck_dim=4, hidden_units=12,
                encoder_h_dim_d=12, mlp_dim=16).items()]
    outs = {k: tmp / f"ranks_{k}" for k in ("steps", "sweep", "cli")}
    for d in outs.values():
        d.mkdir()
    DP.spawn(DP.each_rank, WORLD, "gloo", init_file=str(tmp / "store"),
             args=([(DP.sweep_steps_rank, jobs, str(outs["steps"])),
                    (DP.sweep_rank, sweep, str(outs["sweep"])),
                    (DP.cli_rank, dict(argv=argv, data_dir=str(root),
                                       entry="cli_many"),
                     str(outs["cli"]))],))
    ranks = {k: DP.load_results(str(d), WORLD) for k, d in outs.items()}
    assert [r["foreign_modules"] for rs in ranks.values()
            for r in rs] == [[]] * (WORLD * len(outs))
    return dict(tmp=tmp, root=root, refs=refs, jobs=jobs, sweep=sweep,
                ranks=ranks)


def _hold_steps(rank, ref, job, rtol, what):
    """A run of the sweep's steps (rank's results) per seed against
    ``ref[i]`` = (losses, (D grads, G grads), (D, G) after the steps)."""
    cfg = job.cfg
    modules = {"d": TrajectoryDiscriminator(cfg),
               "g": TrajectoryGenerator(cfg)}
    for i, (losses, (d_grads, g_grads), (d_ref, g_ref)) in enumerate(ref):
        where = f"{what} seed {SEEDS[i]}"
        assert set(rank["losses"]) == set(losses)
        for k, r in losses.items():
            np.testing.assert_allclose(float(rank["losses"][k][i]), r,
                                       rtol=1e-5, atol=MD.LOSS_ATOL,
                                       err_msg=f"{where} {k}")
        for part, grads, w_ref, lr in (
                ("d", d_grads, d_ref, O.TCFG.d_learning_rate),
                ("g", g_grads, g_ref, O.TCFG.g_learning_rate)):
            module = modules[part]
            names = [n for n, _ in module.named_parameters()]
            bound = O._assert_grads(
                module, [rank[f"{part}_grads"][n][i] for n in names], grads,
                f"{where} {part}", rtol)
            O._assert_params(TDP._loaded(module, rank["seeds"][i][part]),
                             w_ref, grads, bound, lr, f"{where} {part}")


def _numpy(ref_run):
    """The port's one-process sweep steps (``_sweep_steps`` on the whole
    batch) in ``_hold_steps``' reference form."""
    out = []
    for i in range(len(SEEDS)):
        out.append(({k: float(v[i]) for k, v in ref_run["losses"].items()},
                    tuple({n: v[i].numpy() for n, v in
                           ref_run[f"{p}_grads"].items()} for p in "dg"),
                    tuple({n: v.numpy() for n, v in
                           ref_run["seeds"][i][p].items()} for p in "dg")))
    return out


@pytest.mark.parametrize("name", sorted([*CONFIGS, *EXTRA]))
def test_sweep_steps_match_grouptraj_mesh(name, runs):
    """Two seeds' d-step + g-step on 2 gloo ranks against ``jax.vmap`` of
    grouptraj's steps on a 2-device mesh with JAX's draws injected, and
    against the port's sweep in one process; the ranks agree bit for
    bit. The models of :data:`EXTRA`: on 2 ranks against one process."""
    job, ref = runs["jobs"][name], runs["refs"].get(name)
    ranks = [r[name] for r in runs["ranks"]["steps"]]
    rtol = 3e-5 if job.cfg.batch_norm else 1e-6
    for key in ("losses", "d_grads", "g_grads"):
        for k, v in ranks[0][key].items():
            assert torch.equal(v, ranks[1][key][k]), (key, k)
    for a, b in zip(ranks[0]["seeds"], ranks[1]["seeds"]):
        assert all(torch.equal(a[p][k], b[p][k]) for p in "dg" for k in a[p])
    if ref is not None:
        _hold_steps(ranks[0], ref, job, rtol,
                    f"{name} 2 ranks vs grouptraj mesh")
    one = _numpy(DP._sweep_steps(0, 1, torch.device("cpu"), job))
    assert get_dp_group() is None
    assert all(r[0]["norm_d"] > 0 and r[0]["norm_g"] > 0
               for r in ref or one)
    _hold_steps(ranks[0], one, job, rtol, f"{name} 2 ranks vs 1 process")


def _one_process(sweep):
    """The port's one-process train_many runs of (b), as sweep_rank
    records them."""
    out = []
    base = dataclasses.replace(sweep["tcfg"], num_devices=1,
                               output_dir=sweep["tcfg"].output_dir + "_one")
    for iters, restore in RUNS:
        ckpts, st = MULTI.train_many(
            sweep["cfg"], dataclasses.replace(
                base, num_iterations=iters, restore_from_checkpoint=restore),
            SEEDS, device="cpu", return_state=True)
        out.append(dict(DP.stacked_tensors(st), ckpt=ckpts))
    return out


def test_train_many_matches_one_process(runs, monkeypatch):
    """train_many with num_devices=2 over 2 buckets, a checkpoint at t=2
    and a resume to t=4 from rank 0's sweep directory, against one
    process: histories, weights, Adam moments, generators; only rank 0
    writes files."""
    monkeypatch.setenv("GROUPTRAJ_DATA_DIR", str(runs["root"]))
    one = _one_process(runs["sweep"])
    ranks = [r["runs"] for r in runs["ranks"]["sweep"]]
    out = runs["sweep"]["tcfg"].output_dir
    assert os.listdir(out) == ["rank0"]
    assert sorted(os.listdir(os.path.join(out, "rank0"))) == [
        f"s{s}" for s in SEEDS]
    for s in SEEDS:
        assert sorted(os.listdir(os.path.join(out, "rank0", f"s{s}"))) == [
            "ck_no_model.pt", "ck_with_model.pt"]
    assert any(max(one[-1]["ckpt"][s]["norm_d"]) > 0 for s in SEEDS)
    for r, rank in enumerate(ranks):
        assert rank[-1]["reduce_calls"] > 0
        for run, ref in zip(rank, one):
            for i, s in enumerate(SEEDS):
                got, want = run["ckpt"][s], ref["ckpt"][s]
                where = (r, s, want["counters"]["t"])
                for k in ("losses_ts", "sample_ts", "restore_ts",
                          "counters", "best_t", "best_t_nl"):
                    assert got[k] == want[k], (where, k)
                g, w = TDP._flat(got), TDP._flat(want)
                assert set(g) == set(w)
                for k, v in w.items():
                    assert np.abs(g[k] - v).max() <= 1e-5 * np.abs(v).max(), \
                        (where, k, g[k], v)
                assert np.array_equal(got[MULTI.RNG_KEY].numpy(),
                                      want[MULTI.RNG_KEY]), where
                iters = want["counters"]["t"]
                for part in ("g", "d"):
                    lr = TDP.TRAIN_LR[part]
                    rms = {n: ref["adam"][f"{part}.{n}.exp_avg_sq"][i].sqrt()
                           for n in ref[part]}
                    top = max(v.max() for v in rms.values())
                    for name, v in ref[part].items():
                        tol = torch.where(rms[name] < 1e-6 * top,
                                          lr * iters, 1e-6)
                        err = (run[part][name][i] - v[i]).abs()
                        assert (err <= tol).all(), (where, part, name,
                                                    err.max() / lr)
                    keys = [k for k in ref["adam"] if k.startswith(part + ".")
                            and not k.endswith(".step")]
                    top = max(ref["adam"][k][i].abs().max().item()
                              for k in keys)
                    for k in keys:
                        err = (run["adam"][k][i] - ref["adam"][k][i]).abs()
                        assert err.max() <= 1e-6 * top, (where, k)
                    assert all(torch.equal(run["adam"][k], ref["adam"][k])
                               for k in ref["adam"]
                               if k.startswith(part + ".")
                               and k.endswith(".step"))


def test_cli_many_under_torchrun(runs):
    """``python -m grouptraj_torch.train.cli_many --num_devices 2
    --dist_backend gloo`` on each rank as torchrun starts it: both ranks
    end with the same histories, rank 0 writes every seed's files into the
    one output directory."""
    cli0, cli1 = (r["ckpt"] for r in runs["ranks"]["cli"])
    assert cli0 == cli1 and set(cli0) == set(SEEDS)
    for s in SEEDS:
        assert cli0[s]["counters"]["t"] == 2
        assert all(np.isfinite(v).all()
                   for v in TDP._flat(cli0[s]).values())
        assert sorted(os.listdir(runs["tmp"] / "cli" / f"s{s}")) == [
            "cli_no_model.pt", "cli_with_model.pt"]


def test_dryrun_sweep_stage():
    """``dryrun_data_parallel(2)``, ``dryrun_multichip``'s counterpart: the
    single-seed iterations (stages 1-3) and the 2-seed sweep (its stage 4)
    on 2 gloo ranks at two bucket widths, against one process."""
    DP.dryrun_data_parallel(WORLD)
    assert get_dp_group() is None


def test_mask_shapes_hold_across_group_boundaries():
    """The mask-shape dry runs (``d_mask_shapes``, ``sample_mask_shapes``,
    ``disc_mask_shapes``) run with no group in force, so called under a
    group (a rank's, installed without a process group: the dry runs make
    no collective) they give what one process gives, and an answer cached
    on either side of a group boundary holds on the other. A rank's sweep
    draws (``replica_draws``, rank 1 of 2) are the global batch's: D's
    keep-masks whole at the global shapes, the noise and the per-sample
    masks sliced to the rank's scenes."""
    cfg = ModelConfig(**O.NARROW, dropout=0.2)
    fns = (TS.d_mask_shapes, TS.sample_mask_shapes, TS.disc_mask_shapes)
    fresh = {f: f.__wrapped__(cfg, S, N) for f in fns}
    assert all(fresh.values())
    assert fresh[TS.d_mask_shapes] == (fresh[TS.sample_mask_shapes]
                                       + TS.disc_mask_shapes(cfg, 2 * S, N))
    for first in (DPGroup(0, WORLD), None):
        for f in fns:
            f.cache_clear()
        for dp in (first, None if first else DPGroup(1, WORLD)):
            prev = set_dp_group(dp)
            try:
                for f in fns:
                    assert f(cfg, S, N) == fresh[f], (f.__name__, dp)
                    assert f.__wrapped__(cfg, S, N) == fresh[f]
            finally:
                set_dp_group(prev)
    L = S // WORLD
    gen = torch.Generator().manual_seed(3)
    prev = set_dp_group(DPGroup(1, WORLD))
    try:
        d = TS.replica_draws("d", cfg, O.TCFG, L, N, gen, "cpu")
        g = TS.replica_draws("g", cfg, O.TCFG, L, N, gen, "cpu")
    finally:
        set_dp_group(prev)
    shapes = lambda f, s: [sh for sh, _ in f(cfg, s, N)]
    assert [tuple(m.shape) for m in d["masks"]] == shapes(TS.d_mask_shapes,
                                                          S)
    assert [tuple(m.shape) for m in g["d_masks"]] == shapes(
        TS.disc_mask_shapes, S)
    assert [tuple(m.shape) for m in g["sample_masks"]] == [
        (BEST_K, *sh) for sh in shapes(TS.sample_mask_shapes, L)]
    assert d["noise"].shape[0] == L and g["noises"].shape[:2] == (BEST_K, L)
    # the same generator on one process draws the global batch's; the rank
    # keeps its block of scenes
    gen = torch.Generator().manual_seed(3)
    d1 = TS.replica_draws("d", cfg, O.TCFG, S, N, gen, "cpu")
    assert torch.equal(d1["noise"][L:], d["noise"])
    assert all(torch.equal(a, b) for a, b in zip(d1["masks"], d["masks"]))
