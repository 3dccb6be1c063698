"""JAX ``UnsupervisedPart`` / ``SupervisedPart`` params -> the port's
``state_dict``.

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
