"""Weights between the JAX package and the port.

The port's `state_dict` keys are the reference checkpoint's keys, which
`occdepth_tpu/training/convert_torch.py::convert_state_dict` maps onto the
JAX package's flax variables.  `state_dict_from_jax` is the exact inverse:
it turns `{"params", "batch_stats"}` (NumPy leaves) back into a
`state_dict` that loads into `OccDepthModel` with `strict=True`.
`load_reference_checkpoint` loads a released reference checkpoint (a
Lightning `.ckpt` or a plain state_dict) into the port natively: its keys
are the port's keys.

Layout transforms (inverse of the converter's):
    Conv2d   (kh, kw, I, O)        -> (O, I, kh, kw)
    Conv3d   (kd, kh, kw, I, O)    -> (O, I, kd, kh, kw)
    ConvT3d  (kd, kh, kw, O, I)    -> (I, O, kd, kh, kw)
    Linear   (I, O)                -> (O, I)
    BatchNorm scale/bias + batch_stats mean/var -> weight/bias/running_*
"""
from __future__ import annotations

from collections import OrderedDict
from typing import Any, Dict, List, Tuple

import torch.nn as nn

import numpy as np
import torch

from occdepth_tpu_torch.config import OccDepthConfig
from occdepth_tpu_torch.models.efficientnet import B0_STAGES, variant_channels

# (torch key prefix, flax path, kind, has_bias)
Entry = Tuple[str, str, str, bool]

_INVERSE = {
    "conv2d": (3, 2, 0, 1),
    "conv3d": (4, 3, 0, 1, 2),
    "convT3d": (4, 3, 0, 1, 2),
    "dense": (1, 0),
}


def _bottleneck3d(out: List[Entry], f: str, t: str, stride: int = 1,
                  has_downsample: bool = False) -> None:
    for i in range(1, 6):
        out.append((f"{t}.conv{i}", f"{f}/conv{i}", "conv3d", False))
        out.append((f"{t}.bn{i}", f"{f}/bn{i}", "bn", True))
    if stride != 1:
        for d in (2, 3, 4):
            out.append((f"{t}.downsample{d}.1", f"{f}/downsample{d}_conv",
                        "conv3d", False))
            out.append((f"{t}.downsample{d}.2", f"{f}/downsample{d}_bn",
                        "bn", True))
    if has_downsample:
        out.append((f"{t}.downsample.1", f"{f}/downsample_conv", "conv3d",
                    False))
        out.append((f"{t}.downsample.2", f"{f}/downsample_bn", "bn", True))


def _process(out, f, t, n_blocks):
    for i in range(n_blocks):
        _bottleneck3d(out, f"{f}/block{i}", f"{t}.main.{i}")


def _aspp(out, f, t):
    for i in range(3):
        out.append((f"{t}.conv1.{i}", f"{f}/conv1_{i}", "conv3d", False))
        out.append((f"{t}.bn1.{i}", f"{f}/bn1_{i}", "bn", True))
        out.append((f"{t}.conv2.{i}", f"{f}/conv2_{i}", "conv3d", False))
        out.append((f"{t}.bn2.{i}", f"{f}/bn2_{i}", "bn", True))


def _efficientnet(out, f, t, variant):
    cfg = variant_channels(variant)
    out.append((f"{t}.conv_stem", f"{f}/conv_stem", "conv2d", False))
    out.append((f"{t}.bn1", f"{f}/bn1", "bn", True))
    for si, (expand, _, _, _, _) in enumerate(B0_STAGES):
        for bi in range(cfg["repeats"][si]):
            fb, tb = f"{f}/blocks_{si}_{bi}", f"{t}.blocks.{si}.{bi}"
            if expand == 1:
                names = [("conv_dw", False), ("bn1", None),
                         ("se/conv_reduce", True), ("se/conv_expand", True),
                         ("conv_pw", False), ("bn2", None)]
            else:
                names = [("conv_pw", False), ("bn1", None),
                         ("conv_dw", False), ("bn2", None),
                         ("se/conv_reduce", True), ("se/conv_expand", True),
                         ("conv_pwl", False), ("bn3", None)]
            for name, bias in names:
                tk = f"{tb}.{name.replace('/', '.')}"
                if bias is None:
                    out.append((tk, f"{fb}/{name}", "bn", True))
                else:
                    out.append((tk, f"{fb}/{name}", "conv2d", bias))
    out.append((f"{t}.conv_head", f"{f}/conv_head", "conv2d", False))


def _unet2d(out, cfg):
    _efficientnet(out, "net_rgb/encoder", "net_rgb.encoder.original_model",
                  cfg.backbone_2d_name)
    out.append(("net_rgb.decoder.conv2", "net_rgb/conv2", "conv2d", True))
    for s in (16, 8, 4, 2, 1):
        if cfg.return_up_feats <= s:
            t, f = f"net_rgb.decoder.up{s}._net", f"net_rgb/up{s}"
            out.append((f"{t}.0", f"{f}/conv0", "conv2d", True))
            out.append((f"{t}.1", f"{f}/bn0", "bn", True))
            out.append((f"{t}.3", f"{f}/conv1", "conv2d", True))
            out.append((f"{t}.4", f"{f}/bn1", "bn", True))
            out.append((f"net_rgb.decoder.resize_output_1_{s}",
                        f"net_rgb/resize_output_1_{s}", "conv2d", True))


def _unet3d(out, cfg):
    f = t = "net_3d_decoder"
    if cfg.dataset == "NYU":  # the reference's NYU decoder names
        p1, p2, u1, u2, head = ("process_1_4", "process_1_8", "up_1_16_1_8",
                                "up_1_8_1_4", "ssc_head_1_4")
    else:
        p1, p2, u1, u2, head = ("process_l1", "process_l2", "up_13_l2",
                                "up_12_l1", "ssc_head")
    _process(out, f"{f}/process_l1", f"{t}.{p1}.0", 3)
    _bottleneck3d(out, f"{f}/down_l1/main", f"{t}.{p1}.1.main", 2, True)
    _process(out, f"{f}/process_l2", f"{t}.{p2}.0", 3)
    _bottleneck3d(out, f"{f}/down_l2/main", f"{t}.{p2}.1.main", 2, True)
    if cfg.context_prior:
        fc, tc = f"{f}/cp_mega_voxels", f"{t}.CP_mega_voxels"
        _aspp(out, f"{fc}/aspp", f"{tc}.aspp")
        out.append((f"{tc}.mega_context.0", f"{fc}/mega_context", "conv3d",
                    True))
        for r in range(cfg.n_relations):
            out.append((f"{tc}.context_prior_logits.{r}.0",
                        f"{fc}/context_prior_logits_{r}", "conv3d", True))
        out.append((f"{tc}.resize.0", f"{fc}/resize_conv", "conv3d", False))
        _process(out, f"{fc}/resize_process", f"{tc}.resize.1", 1)
    # up_l1_lfull (KITTI and TartanAir only) is an Upsample at
    # project_scale 2 and a Convblock3d at 1: the same keys, a transposed
    # conv either way
    ups = [("up_13_l2", u1), ("up_12_l1", u2)]
    if cfg.dataset != "NYU":
        ups.append(("up_l1_lfull", "up_l1_lfull"))
    for fname, tname in ups:
        out.append((f"{t}.{tname}.main.0", f"{f}/{fname}/conv", "convT3d",
                    True))
        out.append((f"{t}.{tname}.main.1", f"{f}/{fname}/bn", "bn", True))
    _seg_head(out, f"{f}/ssc_head", f"{t}.{head}", cfg.cascade_cls, False)
    if cfg.occluded_cls:
        _seg_head(out, f"{f}/occluded_head", f"{t}.occluded_head", False,
                  True)


def _seg_head(out, f, t, cascade, occluded):
    out.append((f"{t}.conv0", f"{f}/conv0", "conv3d", True))
    _aspp(out, f, t)
    if cascade or occluded:
        out.append((f"{t}.occ_classes", f"{f}/occ_classes", "conv3d", True))
    if not occluded:
        out.append((f"{t}.conv_classes", f"{f}/conv_classes", "conv3d", True))


def _flosp_depth(out):
    f, t = "flosp_depth/depth_net", "flosp_depth.depth_net.0"
    out.append((f"{t}.reduce_conv.0", f"{f}/reduce_conv", "conv2d", True))
    out.append((f"{t}.reduce_conv.1", f"{f}/reduce_bn", "bn", True))
    out.append((f"{t}.mlp.fc1", f"{f}/mlp_fc1", "dense", True))
    out.append((f"{t}.mlp.fc2", f"{f}/mlp_fc2", "dense", True))
    out.append((f"{t}.se.conv_reduce", f"{f}/se_reduce", "conv2d", True))
    out.append((f"{t}.se.conv_expand", f"{f}/se_expand", "conv2d", True))
    for i in range(3):
        b, fb = f"{t}.depth_conv.{i}", f"{f}/depth_conv_{i}"
        out.append((f"{b}.conv1", f"{fb}/conv1", "conv2d", False))
        out.append((f"{b}.bn1", f"{fb}/bn1", "bn", True))
        out.append((f"{b}.conv2", f"{fb}/conv2", "conv2d", False))
        out.append((f"{b}.bn2", f"{fb}/bn2", "bn", True))
    out.append((f"{t}.depth_pred", f"{f}/depth_pred", "conv2d", True))


def key_map(cfg: OccDepthConfig) -> List[Entry]:
    """Every (torch prefix, flax path, kind, has_bias) the model holds."""
    out: List[Entry] = []
    _unet2d(out, cfg)
    _unet3d(out, cfg)
    if cfg.trans_2d_to_3d == "flosp_depth":
        _flosp_depth(out)
    return out


def _leaf(tree: Dict[str, Any], path: str) -> np.ndarray:
    node = tree
    for k in path.split("/"):
        node = node[k]
    return np.asarray(node)


def state_dict_from_jax(variables: Dict[str, Any],
                        cfg: OccDepthConfig) -> "OrderedDict[str, torch.Tensor]":
    """JAX `{"params", "batch_stats"}` -> the port's `state_dict`.

    Raises KeyError if the variables lack a leaf the model needs.
    """
    params, stats = variables["params"], variables["batch_stats"]
    sd: "OrderedDict[str, torch.Tensor]" = OrderedDict()
    for tkey, fpath, kind, has_bias in key_map(cfg):
        if kind == "bn":
            base = f"{fpath}/BatchNorm_0"
            sd[f"{tkey}.weight"] = _leaf(params, f"{base}/scale")
            sd[f"{tkey}.bias"] = _leaf(params, f"{base}/bias")
            sd[f"{tkey}.running_mean"] = _leaf(stats, f"{base}/mean")
            sd[f"{tkey}.running_var"] = _leaf(stats, f"{base}/var")
            sd[f"{tkey}.num_batches_tracked"] = np.array(0, np.int64)
            continue
        sd[f"{tkey}.weight"] = np.transpose(
            _leaf(params, f"{fpath}/kernel"), _INVERSE[kind])
        if has_bias:
            sd[f"{tkey}.bias"] = _leaf(params, f"{fpath}/bias")
    return OrderedDict(
        (k, torch.from_numpy(np.array(v, order="C"))) for k, v in sd.items()
    )


def load_reference_checkpoint(model: nn.Module, path: str) -> List[str]:
    """Load a reference PyTorch checkpoint into `model` in place.

    Counterpart of `convert_torch.load_torch_checkpoint` /
    `load_torch_into_state`: `path` holds a Lightning `.ckpt` (weights
    under `state_dict`, keys maybe prefixed `model.`) or a plain
    state_dict.  Keys the model does not hold are ignored; keys the model
    holds and the checkpoint lacks (BatchNorm's `num_batches_tracked`
    aside, which eval never reads) keep their values and are returned, and
    a warning line names them as the JAX package prints it.
    """
    ckpt = torch.load(path, map_location="cpu", weights_only=False)
    sd = ckpt.get("state_dict", ckpt)
    if any(k.startswith("model.") for k in sd):
        sd = {k[len("model."):]: v for k, v in sd.items()
              if k.startswith("model.")}
    own = model.state_dict()
    missing = [k for k in own if k not in sd
               and not k.endswith("num_batches_tracked")]
    model.load_state_dict({k: v for k, v in sd.items() if k in own},
                          strict=False)
    if missing:
        print(f"WARNING: {len(missing)} torch keys not found, e.g. "
              f"{missing[:5]}")
    return missing
