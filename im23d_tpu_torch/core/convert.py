"""JAX params -> the port's ``state_dict``: ``UnsupervisedPart`` /
``SupervisedPart`` (Pipeline A), ``ReconstructionNetwork`` and
``DatasetParams`` (Pipeline B), ``InceptionV3Features`` (FID).

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


def _encoder_decoder(sd: dict, p: dict, num_convs: int) -> None:
    for i in range(num_convs):
        _put(sd, f"encoder.conv.{i}", _layer(p, f"encoder/Conv_{i}"))
    for j in range(2):
        _put(sd, f"encoder.dense.{j}", _layer(p, f"encoder/Dense_{j}"))
    _put(sd, "decoder.points", _layer(p, "decoder/Dense_0"))
    _put(sd, "decoder.scale", _layer(p, "decoder/Dense_1"))


def unsupervised_part_state_dict(params: dict, num_candidates: int,
                                 num_convs: int = 9) -> dict:
    """Map flax ``UnsupervisedPart`` params to ``UnsupervisedPart.state_dict``
    keys of ``im23d_tpu_torch.models.pointcloud_nets``."""
    p = params.get("params", params)
    sd: dict[str, torch.Tensor] = {}
    _encoder_decoder(sd, p, num_convs)
    pd = "pose_decoder"
    _put(sd, f"{pd}.student_trunk", _layer(p, f"{pd}/student_trunk"))
    _put(sd, f"{pd}.ensemble_trunk", _layer(p, f"{pd}/ensemble_trunk"))
    for j in range(3):
        _put(sd, f"{pd}.student_head.dense.{j}",
             _layer(p, f"{pd}/student_head/Dense_{j}"))
        for k in range(num_candidates):
            _put(sd, f"{pd}.heads.{k}.dense.{j}",
                 _layer(p, f"{pd}/head_{k}/Dense_{j}"))
    return sd


def supervised_part_state_dict(params: dict, num_convs: int = 9) -> dict:
    """Map flax ``SupervisedPart`` params to ``SupervisedPart.state_dict``
    keys."""
    sd: dict[str, torch.Tensor] = {}
    _encoder_decoder(sd, params.get("params", params), num_convs)
    return sd


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
