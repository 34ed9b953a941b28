"""Checkpoint configs and weight carry-over (counterpart of
``grouptraj/compat/torch_import.py``).

The port's generator keeps the reference's torch state-dict names and
layouts (``encoder.encoder.weight_ih_l0``, ``pool_net.mlp_pre_pool.2.weight``,
...), so a zoo ``g_state`` loads directly. :func:`params_from_jax` is the
bridge from a JAX generator parameter tree (``[in, out]`` weights, gate
order i,f,g,o) to that state dict — the port's own copy of the
``export_state_dicts`` mapping for every preset's generator (with the
``pool_every_timestep`` decoder's ``pool_net`` and ``mlp``) — and takes the
``global`` and ``local`` discriminators' trees as well;
:func:`params_to_jax` is its inverse.

The optimizer state crosses too. grouptraj checkpoints hold optax's state
of ``chain(clip_by_global_norm, adam)``: ``(EmptyState(),
(ScaleByAdamState(count, mu, nu), EmptyState()))`` for the generator (clip
2.0) and ``((ScaleByAdamState(count, mu, nu), EmptyState()),)`` for the
discriminator (clip 0: no clip), ``count`` an int32 0-d array and
``mu``/``nu`` trees shaped like the parameters. :func:`optax_from_adam`
writes a ``torch.optim.Adam``'s moments in that form (with this module's
stand-ins for the two optax classes, which ``train/checkpoint.py`` pickles
under optax's names) and :func:`adam_from_optax` reads them back:
``step`` is ``count``, ``exp_avg``/``exp_avg_sq`` are ``mu``/``nu``,
transposed like their weights.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Mapping, NamedTuple, Optional

import numpy as np
import torch
from torch import nn

from grouptraj_torch.config import ModelConfig


def config_from_checkpoint_args(args: dict, g_state=None) -> ModelConfig:
    """Resurrect a ModelConfig from a checkpoint's stored flag dict, with
    graph-module era detection from the parameter names when a g_state is
    given (``grouptraj/compat/torch_import.py:config_from_checkpoint_args``).
    grouptraj-written checkpoints carry the resolved config under
    ``args['resolved_model_config']``; reference checkpoints go through the
    weight-name forensics below."""
    rc = args.get("resolved_model_config")
    if rc:
        fields = {f.name for f in dataclasses.fields(ModelConfig)}
        kw = {k: (tuple(v) if isinstance(v, list) else v)
              for k, v in dict(rc).items() if k in fields}
        # pool_impl is an execution preference, not architecture
        kw.pop("pool_impl", None)
        return ModelConfig(**kw)
    noise_dim = args.get("noise_dim") or (0,)
    if isinstance(noise_dim, list):
        noise_dim = tuple(noise_dim)
    graph_module = "gat"
    mlp_ctx = False
    mh_units, mh_heads = (40, 16, 40), (4, 1)
    if g_state is not None:
        if "gatencoder.gat_intra.attention_0.W" in g_state:
            graph_module = "gat"
        elif "gatencoder.gat_net.layer_stack.0.w" in g_state:
            graph_module = "gat-mh"
            mlp_ctx = True
            units, heads = [], []
            i = 0
            while f"gatencoder.gat_net.layer_stack.{i}.w" in g_state:
                w = g_state[f"gatencoder.gat_net.layer_stack.{i}.w"]
                if i == 0:
                    units.append(w.shape[1])
                units.append(w.shape[2])
                heads.append(w.shape[0])
                i += 1
            mh_units, mh_heads = tuple(units), tuple(heads)
        elif "gcn_module.gcn_intra.W.0" in g_state:
            graph_module = "gcn"
        else:
            graph_module = "none"
            mlp_ctx = "mlp_decoder_context.0.weight" in g_state
    pooling = args.get("pooling_type") or "none"
    return ModelConfig(
        obs_len=args.get("obs_len", 8),
        pred_len=args.get("pred_len", 12),
        embedding_dim=args.get("embedding_dim", 16),
        num_layers=args.get("num_layers", 1),
        dropout=float(args.get("dropout", 0.0)),
        batch_norm=bool(args.get("batch_norm", False)),
        mlp_dim=args.get("mlp_dim", 64),
        encoder_h_dim_g=args.get("encoder_h_dim_g", 32),
        decoder_h_dim_g=args.get("decoder_h_dim_g", 32),
        noise_dim=noise_dim,
        noise_type=args.get("noise_type", "gaussian"),
        noise_mix_type=args.get("noise_mix_type", "global"),
        pooling_type=pooling,
        pool_every_timestep=bool(args.get("pool_every_timestep", False)),
        bottleneck_dim=args.get("bottleneck_dim", 8),
        graph_module=graph_module,
        mlp_decoder_context=mlp_ctx,
        n_heads=args.get("n_heads", 1),
        dropout1=float(args.get("dropout1", 0.0)),
        alpha=float(args.get("alpha", 0.2)),
        d_type=args.get("d_type", "global"),
        encoder_h_dim_d=args.get("encoder_h_dim_d", 48),
        neighborhood_size=float(args.get("neighborhood_size", 2.0)),
        grid_size=args.get("grid_size", 8),
        mh_n_units=mh_units, mh_n_heads=mh_heads,
    )


def generator_state(g_state: Mapping) -> Dict[str, torch.Tensor]:
    """A reference or grouptraj ``g_state`` as tensors the port's
    generator loads. Dead weights are dropped, as
    ``grouptraj.compat.import_generator`` and the JAX generator leave them
    unused: the era-(c) ``gcn_module.*`` (always constructed, never called
    when a gatencoder is present), and an era-(b) ``mlp_decoder_context.*``
    beside a live ``gcn_module`` (reference models.py:898-902)."""
    has_gat = any(k.startswith("gatencoder.") for k in g_state)
    has_gcn = not has_gat and "gcn_module.gcn_intra.W.0" in g_state
    dead = ("gcn_module." if has_gat
            else "mlp_decoder_context." if has_gcn else None)
    return {k: v if isinstance(v, torch.Tensor)
            else torch.tensor(np.asarray(v))
            for k, v in g_state.items()
            if dead is None or not k.startswith(dead)}


def discriminator_state(d_state: Mapping) -> Dict[str, torch.Tensor]:
    """A reference or grouptraj ``d_state`` as tensors the port's
    discriminator loads (same names and layouts; arrays become tensors)."""
    return {k: v if isinstance(v, torch.Tensor)
            else torch.tensor(np.asarray(v)) for k, v in d_state.items()}


def params_from_jax(tree: Mapping, kind: str = "generator"
                    ) -> Dict[str, np.ndarray]:
    """JAX params (numpy leaves, ``jax.device_get(params)``) of the
    generator or (``kind='discriminator'``) the discriminator -> the
    torch-named state dict of the port's module. Keys, their order and
    layouts equal ``grouptraj.compat.export_state_dicts(tree, kind)`` for
    every preset's generator and both discriminators; a batch_norm MLP, or
    a tree with parts no port model has, raises NotImplementedError. A JAX
    ``TrainState``'s ``g_params``/``d_params`` thus become the port's G and
    D; the optimizer's moments, trees of the same shape, cross with
    :func:`adam_from_optax`."""
    out: Dict[str, np.ndarray] = {}

    def lin(prefix, p):
        out[prefix + ".weight"] = np.asarray(p["w"]).T
        out[prefix + ".bias"] = np.asarray(p["b"])

    def lstm(prefix, p):
        out[prefix + ".weight_ih_l0"] = np.asarray(p["w_ih"]).T
        out[prefix + ".weight_hh_l0"] = np.asarray(p["w_hh"]).T
        out[prefix + ".bias_ih_l0"] = np.asarray(p["b_ih"])
        out[prefix + ".bias_hh_l0"] = np.asarray(p["b_hh"])

    def mlp(prefix, p):
        for idx, layer in enumerate(p["layers"]):
            if "bn_scale" in layer:
                raise NotImplementedError("batch_norm is not ported yet")
            # make_mlp layout: Linear, activation -> Linear indices 0, 2, ...
            lin(f"{prefix}.{2 * idx}", layer["linear"])

    def gcn(prefix, p):
        for i, w in enumerate(p["W"]):
            out[f"{prefix}.W.{i}"] = np.asarray(w)

    def pool_net(prefix, pn):
        lin(f"{prefix}.spatial_embedding", pn["spatial_embedding"])
        if "mlp_pre_pool" in pn:
            mlp(f"{prefix}.mlp_pre_pool", pn["mlp_pre_pool"])
            return
        gcn(f"{prefix}.gcn_pooling_net_intra", pn["gcn_pooling_net_intra"])
        gcn(f"{prefix}.gcn_pooling_net_inter", pn["gcn_pooling_net_inter"])
        lin(f"{prefix}.out_embedding", pn["out_embedding"])

    def gat(prefix, p):
        for i, att in enumerate(p["attentions"]):
            out[f"{prefix}.attention_{i}.W"] = np.asarray(att["W"])
            out[f"{prefix}.attention_{i}.a"] = np.asarray(att["a"])
        out[f"{prefix}.out_att.W"] = np.asarray(p["out_att"]["W"])
        out[f"{prefix}.out_att.a"] = np.asarray(p["out_att"]["a"])

    def known(parts, allowed):
        if not set(parts) <= set(allowed):
            raise NotImplementedError(
                f"no {kind} of the port has the parts "
                f"{sorted(set(parts) - set(allowed))}")

    if kind == "discriminator":
        known(tree, ("encoder", "real_classifier", "pool_net"))
        lin("encoder.spatial_embedding", tree["encoder"]["spatial_embedding"])
        lstm("encoder.encoder", tree["encoder"]["lstm"])
        mlp("real_classifier", tree["real_classifier"])
        if "pool_net" in tree:
            pool_net("pool_net", tree["pool_net"])
        return out
    if kind != "generator":
        raise ValueError(f"kind must be 'generator' or 'discriminator', "
                         f"got {kind!r}")
    known(tree, ("encoder", "decoder", "pool_net", "gatencoder",
                 "gcn_module", "mlp_decoder_context"))
    dec = tree["decoder"]
    known(dec, ("spatial_embedding", "lstm", "hidden2pos", "pool_net",
                "mlp"))
    lin("encoder.spatial_embedding", tree["encoder"]["spatial_embedding"])
    lstm("encoder.encoder", tree["encoder"]["lstm"])
    lin("decoder.spatial_embedding", dec["spatial_embedding"])
    lstm("decoder.decoder", dec["lstm"])
    lin("decoder.hidden2pos", dec["hidden2pos"])
    if "pool_net" in dec:
        pool_net("decoder.pool_net", dec["pool_net"])
        mlp("decoder.mlp", dec["mlp"])
    if "pool_net" in tree:
        pool_net("pool_net", tree["pool_net"])
    ge = tree.get("gatencoder")
    if ge is not None and "gat_net" in ge:
        for i, layer in enumerate(ge["gat_net"]["layer_stack"]):
            pre = f"gatencoder.gat_net.layer_stack.{i}"
            for name in ("w", "a_src", "a_dst", "bias"):
                out[f"{pre}.{name}"] = np.asarray(layer[name])
    elif ge is not None:
        gat("gatencoder.gat_intra", ge["gat_intra"])
        gat("gatencoder.gat_inter", ge["gat_inter"])
        lin("gatencoder.out_embedding", ge["out_embedding"])
    if "gcn_module" in tree:
        gm = tree["gcn_module"]
        gcn("gcn_module.gcn_intra", gm["gcn_intra"])
        gcn("gcn_module.gcn_inter", gm["gcn_inter"])
        lin("gcn_module.out_embedding", gm["out_embedding"])
    if "mlp_decoder_context" in tree:
        mlp("mlp_decoder_context", tree["mlp_decoder_context"])
    return out


def params_to_jax(state: Mapping, kind: str = "generator") -> dict:
    """The inverse of :func:`params_from_jax`: a torch-named state dict
    (tensors or arrays) of the port's generator or discriminator -> the
    JAX package's parameter tree, as numpy arrays (``[out, in]`` weights
    transposed to ``[in, out]``). The tree is the one
    ``grouptraj.compat.import_generator`` / ``import_discriminator`` build
    from the same names, so an optax state over it matches the JAX
    package's own."""
    sd = {k: (v.detach().cpu().numpy() if isinstance(v, torch.Tensor)
              else np.asarray(v)) for k, v in state.items()}

    def lin(prefix):
        return {"w": sd[prefix + ".weight"].T, "b": sd[prefix + ".bias"]}

    def lstm(prefix):
        return {"w_ih": sd[prefix + ".weight_ih_l0"].T,
                "w_hh": sd[prefix + ".weight_hh_l0"].T,
                "b_ih": sd[prefix + ".bias_ih_l0"],
                "b_hh": sd[prefix + ".bias_hh_l0"]}

    def mlp(prefix):
        idxs = sorted({int(k[len(prefix) + 1:].split(".")[0])
                       for k in sd if k.startswith(prefix + ".")})
        return {"layers": [{"linear": lin(f"{prefix}.{i}")} for i in idxs]}

    def gcn(prefix):
        ws, i = [], 0
        while f"{prefix}.W.{i}" in sd:
            ws.append(sd[f"{prefix}.W.{i}"])
            i += 1
        return {"W": ws}

    def pool_net(prefix):
        if f"{prefix}.gcn_pooling_net_intra.W.0" in sd:
            return {"spatial_embedding": lin(f"{prefix}.spatial_embedding"),
                    "gcn_pooling_net_intra":
                        gcn(f"{prefix}.gcn_pooling_net_intra"),
                    "gcn_pooling_net_inter":
                        gcn(f"{prefix}.gcn_pooling_net_inter"),
                    "out_embedding": lin(f"{prefix}.out_embedding")}
        return {"spatial_embedding": lin(f"{prefix}.spatial_embedding"),
                "mlp_pre_pool": mlp(f"{prefix}.mlp_pre_pool")}

    def gat(prefix):
        heads = sorted({int(k[len(prefix) + 11:].split(".")[0])
                        for k in sd if k.startswith(prefix + ".attention_")})
        return {"attentions": [{"W": sd[f"{prefix}.attention_{i}.W"],
                                "a": sd[f"{prefix}.attention_{i}.a"]}
                               for i in heads],
                "out_att": {"W": sd[f"{prefix}.out_att.W"],
                            "a": sd[f"{prefix}.out_att.a"]}}

    tree = {"encoder": {"spatial_embedding": lin("encoder.spatial_embedding"),
                        "lstm": lstm("encoder.encoder")}}
    has_pool = "pool_net.spatial_embedding.weight" in sd
    if kind == "discriminator":
        tree["real_classifier"] = mlp("real_classifier")
        if has_pool:
            tree["pool_net"] = pool_net("pool_net")
        return tree
    if kind != "generator":
        raise ValueError(f"kind must be 'generator' or 'discriminator', "
                         f"got {kind!r}")
    tree["decoder"] = {"spatial_embedding": lin("decoder.spatial_embedding"),
                       "lstm": lstm("decoder.decoder"),
                       "hidden2pos": lin("decoder.hidden2pos")}
    if "decoder.pool_net.spatial_embedding.weight" in sd:
        tree["decoder"]["pool_net"] = pool_net("decoder.pool_net")
        tree["decoder"]["mlp"] = mlp("decoder.mlp")
    if has_pool:
        tree["pool_net"] = pool_net("pool_net")
    if "gatencoder.gat_intra.attention_0.W" in sd:
        tree["gatencoder"] = {
            "gat_intra": gat("gatencoder.gat_intra"),
            "gat_inter": gat("gatencoder.gat_inter"),
            "out_embedding": lin("gatencoder.out_embedding")}
    elif "gatencoder.gat_net.layer_stack.0.w" in sd:
        layers, i = [], 0
        while f"gatencoder.gat_net.layer_stack.{i}.w" in sd:
            pre = f"gatencoder.gat_net.layer_stack.{i}"
            layers.append({name: sd[f"{pre}.{name}"]
                           for name in ("w", "a_src", "a_dst", "bias")})
            i += 1
        tree["gatencoder"] = {"gat_net": {"layer_stack": layers}}
    if "gcn_module.gcn_intra.W.0" in sd:
        tree["gcn_module"] = {"gcn_intra": gcn("gcn_module.gcn_intra"),
                              "gcn_inter": gcn("gcn_module.gcn_inter"),
                              "out_embedding": lin("gcn_module.out_embedding")}
    if "mlp_decoder_context.0.weight" in sd:
        tree["mlp_decoder_context"] = mlp("mlp_decoder_context")
    return tree


class EmptyState(NamedTuple):
    """Stand-in for ``optax.EmptyState``."""


class ScaleByAdamState(NamedTuple):
    """Stand-in for ``optax.ScaleByAdamState``."""
    count: np.ndarray
    mu: dict
    nu: dict


# where optax defines the classes the stand-ins take the place of
OPTAX_CLASSES = {EmptyState: ("optax._src.base", "EmptyState"),
                 ScaleByAdamState: ("optax._src.transform",
                                    "ScaleByAdamState")}


def optax_from_adam(optimizer: torch.optim.Optimizer, module: nn.Module,
                    kind: str, clip: float) -> tuple:
    """``optimizer``'s Adam state over ``module``'s parameters -> the
    state optax's ``chain([clip_by_global_norm(clip),] adam(lr))`` keeps,
    numpy leaves in the JAX layout. Parameters the optimizer has not
    stepped yet have zero moments; ``count`` is their common step."""
    mu, nu, steps = {}, {}, set()
    for name, p in module.named_parameters():
        st = optimizer.state.get(p, {})
        zero = np.zeros(tuple(p.shape), np.float32)
        mu[name] = (st["exp_avg"].detach().cpu().numpy().copy()
                    if "exp_avg" in st else zero)
        nu[name] = (st["exp_avg_sq"].detach().cpu().numpy().copy()
                    if "exp_avg_sq" in st else zero)
        steps.add(int(st["step"]) if "step" in st else 0)
    if len(steps) > 1:
        raise ValueError(f"the parameters were stepped unequally: {steps}")
    adam = ScaleByAdamState(np.asarray(steps.pop() if steps else 0, np.int32),
                            params_to_jax(mu, kind), params_to_jax(nu, kind))
    if clip and clip > 0:
        return (EmptyState(), (adam, EmptyState()))
    return ((adam, EmptyState()),)


def _find_adam(opt_state) -> Optional[tuple]:
    """The ScaleByAdamState inside a chain's nested tuples, or None."""
    if all(hasattr(opt_state, f) for f in ("count", "mu", "nu")):
        return opt_state
    if isinstance(opt_state, tuple):
        for sub in opt_state:
            found = _find_adam(sub)
            if found is not None:
                return found
    return None


def adam_from_optax(opt_state, optimizer: torch.optim.Optimizer,
                    module: nn.Module, kind: str) -> bool:
    """Load an optax Adam chain's state (a grouptraj or port checkpoint's
    ``g_optim_state``/``d_optim_state``) into ``optimizer`` over
    ``module``'s parameters. Returns False, leaving ``optimizer`` as it
    is, when the state holds no Adam moments or their names or shapes do
    not match the parameters (grouptraj's ``_opt_compatible``)."""
    adam = _find_adam(opt_state)
    if adam is None:
        return False
    params = dict(module.named_parameters())
    try:
        mu = params_from_jax(adam.mu, kind)
        nu = params_from_jax(adam.nu, kind)
    except (KeyError, TypeError, NotImplementedError):
        return False
    if set(mu) != set(params) or any(
            tuple(mu[k].shape) != tuple(p.shape)
            or tuple(nu[k].shape) != tuple(p.shape)
            for k, p in params.items()):
        return False
    count = int(np.asarray(adam.count))
    for name, p in params.items():
        optimizer.state[p] = {
            # torch keeps a non-capturable Adam's step on the CPU
            "step": torch.tensor(float(count), dtype=torch.float32),
            "exp_avg": torch.tensor(np.ascontiguousarray(mu[name]),
                                    dtype=p.dtype, device=p.device),
            "exp_avg_sq": torch.tensor(np.ascontiguousarray(nu[name]),
                                       dtype=p.dtype, device=p.device)}
    return True
