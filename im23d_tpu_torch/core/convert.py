"""JAX params -> the port's ``state_dict``: ``UnsupervisedPart`` /
``SupervisedPart`` (Pipeline A), ``ReconstructionNetwork`` and
``DatasetParams`` (Pipeline B), the GAN's ``Generator`` and
``MultiScaleDiscriminator`` (with their ``SpatialAttention``), its
``TextEncoder``, ``InceptionV3Features`` (FID); and the reference's own
``checkpoint_*.pth`` dicts (``load_reference_checkpoint``,
``graft_reference``), whose state dicts carry the port's layer names.

Input is the flax param tree as nested dicts of numpy arrays (what
``jax.tree.map(np.asarray, params)`` gives), with or without the top-level
``"params"`` collection.  Flax conv kernels are HWIO and become OIHW; Dense
kernels are (in, out) and become the Linear weight (out, in).  The port's
encoder flattens in NHWC order, so ``encoder/Dense_0`` needs no row
permutation.
"""

from __future__ import annotations

import numpy as np
import torch
from torch import nn

# the reference's loss curves -> the port's GAN trainer's curve names
REFERENCE_CURVES = (("g_curve", "g_loss"), ("flat_curve", "flat_loss"),
                    ("d_fake_curve", "d_fake"), ("d_real_curve", "d_real"))


def load_reference_checkpoint(path: str) -> dict:
    """A reference ``checkpoint_*.pth`` on the CPU: ``generator`` (and for
    the GAN ``generator_running_avg``, ``text_encoder`` or
    ``text_encoder_g``; for the recon net ``dataset_params``), ``args``,
    ``epoch``, ``iteration`` and the GAN's curves.  ``weights_only=False``:
    the reference pickles its ``args`` snapshot, so load only files you
    trust."""
    return torch.load(path, map_location="cpu", weights_only=False)


def reference_args(chk: dict) -> dict:
    """The checkpoint's ``args`` snapshot as a dict (empty without one)."""
    return dict(chk.get("args") or {})


def graft_reference(module: nn.Module, state_dict: dict, what: str) -> None:
    """Copy each entry of a reference state dict onto ``module``'s entry of
    the same name, in place, in the module's dtype and device, and print
    the count.  A shape mismatch raises ``ValueError`` naming the key
    (the model was built with other hyperparameters than the checkpoint's);
    reference entries with no counterpart, and module entries the
    checkpoint lacks (which keep their values), are printed by name."""
    own = module.state_dict()
    unmatched = []
    n = 0
    with torch.no_grad():
        for key, value in state_dict.items():
            if key not in own:
                unmatched.append(key)
                continue
            value = torch.as_tensor(value)
            if tuple(value.shape) != tuple(own[key].shape):
                raise ValueError(
                    f"shape mismatch at {what}/{key}: checkpoint "
                    f"{tuple(value.shape)} vs model {tuple(own[key].shape)}"
                    f" — the config and the checkpoint disagree")
            own[key].copy_(value)
            n += 1
    print(f"{what}: grafted {n}/{len(own)} model entries")
    for key in unmatched:
        print(f"  WARNING: checkpoint entry with no model counterpart: "
              f"{what}/{key}")
    for key in own:
        if key not in state_dict and not key.endswith("num_batches_tracked"):
            print(f"  WARNING: model entry missing from the checkpoint "
                  f"(kept): {what}/{key}")


def _layer(tree: dict, path: str) -> dict:
    for key in path.split("/"):
        tree = tree[key]
    return tree


def _put(sd: dict, name: str, layer: dict) -> None:
    kernel = np.asarray(layer["kernel"], np.float32)
    if kernel.ndim == 4:       # (kh, kw, in, out) -> (out, in, kh, kw)
        weight = kernel.transpose(3, 2, 0, 1)
    elif kernel.ndim == 2:     # (in, out) -> (out, in)
        weight = kernel.T
    else:
        raise ValueError(f"{name}: unexpected kernel rank {kernel.ndim}")
    sd[f"{name}.weight"] = torch.from_numpy(weight.copy())
    sd[f"{name}.bias"] = torch.from_numpy(
        np.asarray(layer["bias"], np.float32).copy()
    )


def _encoder_decoder_layers(num_convs: int) -> list[tuple[str, str]]:
    return ([(f"encoder.conv.{i}", f"encoder/Conv_{i}")
             for i in range(num_convs)]
            + [(f"encoder.dense.{j}", f"encoder/Dense_{j}") for j in range(2)]
            + [("decoder.points", "decoder/Dense_0"),
               ("decoder.scale", "decoder/Dense_1")])


def unsupervised_part_layers(num_candidates: int, num_convs: int = 9
                             ) -> list[tuple[str, str]]:
    """(module name in the port's ``UnsupervisedPart``, flax param path) of
    each conv and dense layer."""
    pd = "pose_decoder"
    layers = _encoder_decoder_layers(num_convs) + [
        (f"{pd}.student_trunk", f"{pd}/student_trunk"),
        (f"{pd}.ensemble_trunk", f"{pd}/ensemble_trunk")]
    for j in range(3):
        layers.append((f"{pd}.student_head.dense.{j}",
                       f"{pd}/student_head/Dense_{j}"))
        layers += [(f"{pd}.heads.{k}.dense.{j}", f"{pd}/head_{k}/Dense_{j}")
                   for k in range(num_candidates)]
    return layers


def _state_dict(p: dict, layers) -> dict:
    sd: dict[str, torch.Tensor] = {}
    for name, path in layers:
        _put(sd, name, _layer(p, path))
    return sd


def unsupervised_part_state_dict(params: dict, num_candidates: int,
                                 num_convs: int = 9) -> dict:
    """Map flax ``UnsupervisedPart`` params to ``UnsupervisedPart.state_dict``
    keys of ``im23d_tpu_torch.models.pointcloud_nets``."""
    return _state_dict(params.get("params", params),
                       unsupervised_part_layers(num_candidates, num_convs))


def supervised_part_state_dict(params: dict, num_convs: int = 9) -> dict:
    """Map flax ``SupervisedPart`` params to ``SupervisedPart.state_dict``
    keys."""
    return _state_dict(params.get("params", params),
                       _encoder_decoder_layers(num_convs))


def _conv_weight(kernel) -> torch.Tensor:
    """flax HWIO conv kernel -> torch OIHW weight."""
    return torch.from_numpy(
        np.asarray(kernel, np.float32).transpose(3, 2, 0, 1).copy())


def _tensor(x) -> torch.Tensor:
    return torch.from_numpy(np.asarray(x, np.float32).copy())


def _bn_entries(sd: dict, name: str, params: dict, stats: dict) -> None:
    sd[f"{name}.weight"] = _tensor(params["scale"])
    sd[f"{name}.bias"] = _tensor(params["bias"])
    sd[f"{name}.running_mean"] = _tensor(stats["mean"])
    sd[f"{name}.running_var"] = _tensor(stats["var"])


def reconstruction_state_dict(variables: dict) -> dict:
    """Flax ``ReconstructionNetwork`` variables ``{params, batch_stats}`` ->
    the port's ``ReconstructionNetwork.state_dict`` (the reference's torch
    names); the inverse of the JAX package's ``convert_reconstruction``.

    ``fc1e`` consumes the encoder map flattened in torch's (C, H, W) order
    where flax flattens (H, W, C), and ``fc1_tex``'s output is viewed as a
    (256, 4, base_w) map where flax views (4, base_w, 256): their rows and
    columns are permuted accordingly.
    """
    p, s = variables["params"], variables["batch_stats"]
    sd: dict[str, torch.Tensor] = {}
    for i in range(5):
        sd[f"conv{i + 1}e.weight"] = _conv_weight(p[f"Conv_{i}"]["kernel"])
        _bn_entries(sd, f"bn{i + 1}e", p[f"BatchNorm_{i}"],
                    s[f"BatchNorm_{i}"])
    k = np.asarray(p["Dense_0"]["kernel"], np.float32)  # (H*W*64, 256)
    side = int(round((k.shape[0] // 64) ** 0.5))
    sd["fc1e.weight"] = torch.from_numpy(
        k.T.reshape(-1, side, side, 64).transpose(0, 3, 1, 2)
        .reshape(k.shape[1], -1).copy())
    _bn_entries(sd, "bnfc1e", p["BatchNorm_5"], s["BatchNorm_5"])
    sd["fc3e.weight"] = _tensor(np.asarray(p["Dense_1"]["kernel"]).T)
    _bn_entries(sd, "bnfc3e", p["BatchNorm_6"], s["BatchNorm_6"])
    k = np.asarray(p["Dense_2"]["kernel"], np.float32)  # (1024, 4*bw*256)
    base_w = k.shape[1] // (4 * 256)
    sd["fc1_tex.weight"] = torch.from_numpy(
        k.T.reshape(4, base_w, 256, -1).transpose(2, 0, 1, 3)
        .reshape(-1, k.shape[0]).copy())
    sd["fc1_tex.bias"] = torch.from_numpy(
        np.asarray(p["Dense_2"]["bias"], np.float32).reshape(4, base_w, 256)
        .transpose(2, 0, 1).reshape(-1).copy())

    def resblock(flax_name: str, name: str) -> None:
        bp, bs = p[flax_name], s[flax_name]
        # flax names convs by creation order: the 1x1 shortcut, when the
        # channel count changes, is created first
        convs = sorted((k for k in bp if k.startswith("Conv_")),
                       key=lambda k: int(k.split("_")[1]))
        if len(convs) == 3:
            sd[f"{name}.shortcut.weight"] = _conv_weight(bp[convs[0]]["kernel"])
        sd[f"{name}.conv1.weight"] = _conv_weight(bp[convs[-2]]["kernel"])
        sd[f"{name}.conv2.weight"] = _conv_weight(bp[convs[-1]]["kernel"])
        _bn_entries(sd, f"{name}.bn1", bp["BatchNorm_0"], bs["BatchNorm_0"])
        _bn_entries(sd, f"{name}.bn2", bp["BatchNorm_1"], bs["BatchNorm_1"])

    for i, name in enumerate(("blk1", "blk2", "blk3")):
        resblock(f"ResBlock_{i}", name)
    for name in ("blk3b_tex", "blk3c_tex", "blk4_mesh", "blk4_tex",
                 "blk5_tex"):
        if name in p:
            resblock(name, name)
    for name in ("conv_mesh", "conv_tex"):
        sd[f"{name}.weight"] = _conv_weight(p[name]["kernel"])
        sd[f"{name}.bias"] = _tensor(p[name]["bias"])
    return sd


def dataset_params_state_dict(dp_params: dict) -> dict:
    """Flax ``DatasetParams`` params -> the port's ``DatasetParams``
    state dict (the same names)."""
    dp = dp_params.get("params", dp_params)
    return {k: _tensor(v) for k, v in dp.items()}


def _sn_convs(sd: dict, p: dict, s: dict, names: list[str]) -> None:
    """flax ``SpectralNorm(Conv)`` layers ``Conv_i`` (kernel, bias) with
    their ``SpectralNorm_i`` ``u`` -> ``<name>.weight_orig``, ``.bias``,
    ``.weight_u``, in creation order (no ``u`` when ``s`` has none: a tree
    shaped like the params alone, such as Adam's moments)."""
    for i, name in enumerate(names):
        layer = p[f"Conv_{i}"]
        sd[f"{name}.weight_orig"] = _conv_weight(layer["kernel"])
        if "bias" in layer:
            sd[f"{name}.bias"] = _tensor(layer["bias"])
        if f"SpectralNorm_{i}" in s:
            sd[f"{name}.weight_u"] = _tensor(
                np.asarray(s[f"SpectralNorm_{i}"][f"Conv_{i}/kernel/u"])[0])


def _linear_entries(sd: dict, name: str, layer: dict) -> None:
    sd[f"{name}.weight"] = _tensor(np.asarray(layer["kernel"]).T)
    sd[f"{name}.bias"] = _tensor(layer["bias"])


def generator_state_dict(variables: dict) -> dict:
    """Flax ``Generator`` variables ``{params, batch_stats}`` (batch-norm
    moments and spectral-norm ``u``) -> the port's ``Generator.state_dict``
    (the reference's torch names).

    flax reshapes ``fc``'s output as an (8, W, 512) HWC map where the
    reference views a (512, 8, W) CHW one: its columns and bias are
    permuted accordingly.  A ResBlockUp's convs are named by creation order:
    the 1 × 1 shortcut, when the channel count changes, comes first.
    """
    p, s = variables["params"], variables.get("batch_stats", {})
    sd: dict[str, torch.Tensor] = {}
    k = np.asarray(p["fc"]["kernel"], np.float32)  # (z, 8 * W * 512)
    base_w = k.shape[1] // (8 * 512)
    sd["fc.weight"] = torch.from_numpy(
        k.T.reshape(8, base_w, 512, -1).transpose(2, 0, 1, 3)
        .reshape(-1, k.shape[0]).copy())
    sd["fc.bias"] = torch.from_numpy(
        np.asarray(p["fc"]["bias"], np.float32).reshape(8, base_w, 512)
        .transpose(2, 0, 1).reshape(-1).copy())
    for emb in ("emb_class", "emb_color"):
        if emb in p:
            sd[f"{emb}.weight"] = _tensor(p[emb]["embedding"])
    for blk in ("blk1", "blk2", "blk3a", "blk3b", "blk3c", "blk4", "blk5",
                "blk6", "blk3_mesh"):
        if blk not in p:
            continue
        bp, bs = p[blk], s.get(blk, {})
        n_convs = sum(key.startswith("Conv_") for key in bp)
        names = ["shortcut"] * (n_convs == 3) + ["conv1", "conv2"]
        _sn_convs(sd, bp, bs, [f"{blk}.{n}" for n in names])
        for norm in ("norm1", "norm2"):
            for fc in ("fc_gamma", "fc_beta"):
                _linear_entries(sd, f"{blk}.{norm}.{fc}", bp[norm][fc])
            stats = bs.get(norm, {}).get("BatchNorm_0")
            if stats is not None:
                sd[f"{blk}.{norm}.norm.running_mean"] = _tensor(stats["mean"])
                sd[f"{blk}.{norm}.norm.running_var"] = _tensor(stats["var"])
    for name in ("conv_final", "conv_mesh"):
        if name in p:
            sd[f"{name}.weight"] = _conv_weight(p[name]["kernel"])
            sd[f"{name}.bias"] = _tensor(p[name]["bias"])
    _attention(sd, "att", p)
    return sd


def _attention(sd: dict, name: str, p: dict) -> None:
    """A ``SpatialAttention`` ``att`` of ``p``, when there is one: its
    ``conv_context`` kernel (1, 1, words, C) -> (C, words, 1, 1)."""
    if "att" in p:
        sd[f"{name}.conv_context.weight"] = _conv_weight(
            p["att"]["conv_context"]["kernel"])


def discriminator_state_dict(variables: dict) -> dict:
    """Flax ``MultiScaleDiscriminator`` variables ``{params, batch_stats}``
    -> the port's ``MultiScaleDiscriminator.state_dict``: ``d<k>.conv<i>``
    from ``Conv_<i-1>`` and its ``SpectralNorm_<i-1>`` ``u``, the instance
    norms' scale and bias, the projection embeddings."""
    p, s = variables["params"], variables.get("batch_stats", {})
    sd: dict[str, torch.Tensor] = {}
    for d, dp in p.items():
        n_convs = sum(key.startswith("Conv_") for key in dp)
        _sn_convs(sd, dp, s.get(d, {}),
                  [f"{d}.conv{i + 1}" for i in range(n_convs)])
        for bn in ("bn2", "bn3", "bn4"):
            if bn in dp:
                sd[f"{d}.{bn}.weight"] = _tensor(dp[bn]["scale"])
                sd[f"{d}.{bn}.bias"] = _tensor(dp[bn]["bias"])
        for emb in ("projector", "projector_col1"):
            if emb in dp:
                sd[f"{d}.{emb}.weight"] = _tensor(dp[emb]["embedding"])
        _attention(sd, f"{d}.att", dp)
    return sd


def text_encoder_state_dict(params: dict) -> dict:
    """Flax ``TextEncoder`` params -> the port's ``TextEncoder.state_dict``
    (AttnGAN's names): ``embed`` -> ``encoder.weight``; the forward cell
    ``OptimizedLSTMCell_0`` -> ``rnn.*_l0`` and the backward
    ``OptimizedLSTMCell_1`` -> ``rnn.*_l0_reverse``, their gate rows
    [i, f, g, o] stacked from the transposed ``i*`` (input) and ``h*``
    (hidden) kernels; ``bias_ih`` is the ``h*`` biases and ``bias_hh`` 0
    (flax carries one bias a gate)."""
    p = params.get("params", params)
    sd: dict[str, torch.Tensor] = {
        "encoder.weight": _tensor(p["embed"]["embedding"])}
    for cell, suffix in (("OptimizedLSTMCell_0", ""),
                         ("OptimizedLSTMCell_1", "_reverse")):
        c = p[cell]
        sd[f"rnn.weight_ih_l0{suffix}"] = torch.from_numpy(np.concatenate(
            [np.asarray(c[f"i{g}"]["kernel"], np.float32).T
             for g in "ifgo"]).copy())
        sd[f"rnn.weight_hh_l0{suffix}"] = torch.from_numpy(np.concatenate(
            [np.asarray(c[f"h{g}"]["kernel"], np.float32).T
             for g in "ifgo"]).copy())
        bias = np.concatenate([np.asarray(c[f"h{g}"]["bias"], np.float32)
                               for g in "ifgo"])
        sd[f"rnn.bias_ih_l0{suffix}"] = torch.from_numpy(bias)
        sd[f"rnn.bias_hh_l0{suffix}"] = torch.zeros(bias.shape[0])
    return sd


def inception_state_dict(variables: dict) -> dict:
    """Flax ``InceptionV3Features`` variables ``{params, batch_stats}`` ->
    the port's ``InceptionV3Features.state_dict`` (torchvision names); the
    inverse of the JAX package's ``load_torch_state_dict``: conv kernels
    HWIO -> OIHW, batch-norm scale / bias / mean / var -> weight / bias /
    running_mean / running_var."""
    sd: dict[str, torch.Tensor] = {}
    names = {"kernel": "weight", "scale": "weight", "bias": "bias",
             "mean": "running_mean", "var": "running_var"}

    def walk(tree: dict, prefix: tuple) -> None:
        for key, val in tree.items():
            if isinstance(val, dict):
                walk(val, prefix + (key,))
            else:
                name = ".".join(prefix + (names[key],))
                sd[name] = (_conv_weight(val) if key == "kernel"
                            else _tensor(val))

    walk(variables["params"], ())
    walk(variables["batch_stats"], ())
    return sd
