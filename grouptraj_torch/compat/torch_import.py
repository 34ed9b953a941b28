"""Checkpoint configs and weight carry-over (counterpart of
``grouptraj/compat/torch_import.py``).

The port's generator keeps the reference's torch state-dict names and
layouts (``encoder.encoder.weight_ih_l0``, ``pool_net.mlp_pre_pool.2.weight``,
...), so a zoo ``g_state`` loads directly. :func:`params_from_jax` is the
bridge from a JAX generator parameter tree (``[in, out]`` weights, gate
order i,f,g,o) to that state dict — the port's own copy of the
``export_state_dicts`` mapping for the ``gat``, ``gat-mh`` and ``gcn-pool``
generators — and takes the discriminator's tree as well.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Mapping

import numpy as np
import torch

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
    generator loads: the dead era-(c) ``gcn_module.*`` weights (always
    constructed, never called when a gatencoder is present) are dropped,
    as ``grouptraj.compat.import_generator`` drops them."""
    has_gat = any(k.startswith("gatencoder.") for k in g_state)
    return {k: v if isinstance(v, torch.Tensor)
            else torch.tensor(np.asarray(v))
            for k, v in g_state.items()
            if not (has_gat and k.startswith("gcn_module."))}


def discriminator_state(d_state: Mapping) -> Dict[str, torch.Tensor]:
    """A reference or grouptraj ``d_state`` as tensors the port's
    discriminator loads (same names and layouts; arrays become tensors)."""
    return {k: v if isinstance(v, torch.Tensor)
            else torch.tensor(np.asarray(v)) for k, v in d_state.items()}


def params_from_jax(tree: Mapping, kind: str = "generator"
                    ) -> Dict[str, np.ndarray]:
    """JAX params (numpy leaves, ``jax.device_get(params)``) of the
    generator or (``kind='discriminator'``) the discriminator -> the
    torch-named state dict of the port's module. Keys and layouts equal
    ``grouptraj.compat.export_state_dicts(tree, kind)`` for the generators
    the port builds (``gat``, ``gat-mh``, ``gcn-pool``) and the ``global``
    discriminator; other trees raise NotImplementedError. A JAX
    ``TrainState``'s ``g_params``/``d_params`` thus become the port's G and
    D; optimizer moments are not carried (both sides start Adam from zero)
    — bridging a non-zero optimizer state waits for the port's checkpoint
    save."""
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

    later = NotImplementedError(
        "params_from_jax covers the 'gat', 'gat-mh' and 'gcn-pool' "
        "generators and the 'global' discriminator; the other presets are "
        "not ported yet")
    if kind == "discriminator":
        if (set(tree) != {"encoder", "real_classifier", "pool_net"}
                or "mlp_pre_pool" not in tree["pool_net"]):
            raise later
        lin("encoder.spatial_embedding", tree["encoder"]["spatial_embedding"])
        lstm("encoder.encoder", tree["encoder"]["lstm"])
        mlp("real_classifier", tree["real_classifier"])
        pool_net("pool_net", tree["pool_net"])
        return out
    if kind != "generator":
        raise ValueError(f"kind must be 'generator' or 'discriminator', "
                         f"got {kind!r}")
    ge = tree.get("gatencoder", {})
    graph = ("gat-mh" if "gat_net" in ge else "gat" if ge
             else "none" if "mlp_decoder_context" in tree else None)
    gcn_pool = "gcn_pooling_net_intra" in tree.get("pool_net", {})
    extra = set(tree) - {"encoder", "decoder", "pool_net", "gatencoder",
                         "mlp_decoder_context"}
    if (extra or "pool_net" in tree["decoder"] or "pool_net" not in tree
            or graph is None or (graph == "none" and not gcn_pool)
            or (graph == "gat" and "mlp_decoder_context" in tree)):
        raise later
    lin("encoder.spatial_embedding", tree["encoder"]["spatial_embedding"])
    lstm("encoder.encoder", tree["encoder"]["lstm"])
    lin("decoder.spatial_embedding", tree["decoder"]["spatial_embedding"])
    lstm("decoder.decoder", tree["decoder"]["lstm"])
    lin("decoder.hidden2pos", tree["decoder"]["hidden2pos"])
    pool_net("pool_net", tree["pool_net"])
    if graph == "gat-mh":
        for i, layer in enumerate(ge["gat_net"]["layer_stack"]):
            pre = f"gatencoder.gat_net.layer_stack.{i}"
            for name in ("w", "a_src", "a_dst", "bias"):
                out[f"{pre}.{name}"] = np.asarray(layer[name])
    elif graph == "gat":
        gat("gatencoder.gat_intra", ge["gat_intra"])
        gat("gatencoder.gat_inter", ge["gat_inter"])
        lin("gatencoder.out_embedding", ge["out_embedding"])
    if "mlp_decoder_context" in tree:
        mlp("mlp_decoder_context", tree["mlp_decoder_context"])
    return out
