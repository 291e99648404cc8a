"""Import/export reference-style Keras HDF5 weights for zoo models.

Aux subsystem (SURVEY.md section 5, checkpoint row): flypylib saved weights
with Keras ``model.save_weights`` (HDF5).  For bit-comparison against
reference-trained nets [B:5], this maps Keras HDF5 weight files onto zoo
params pytrees — ConvStack, BatchNorm variants, and the U-Net.

Layer-mapping contract (strict — unmatched weights are an error, never a
silent skip):

1. **By name** when every file layer name is a layer in the target
   (``Conv_0``, ``ConvTranspose_1``, ``BatchNorm_2``, ...) — the
   round-trip path written by :func:`save_keras_weights`, covering any
   zoo model including the U-Net.  Every target conv/BN layer must be
   filled and every file layer consumed.
2. **By order** otherwise (foreign Keras files): 5-D conv kernels map to
   ``Conv_*`` in call order and BatchNorm groups to ``BatchNorm_*`` in
   order — valid only for sequential stacks; targets containing
   ``ConvTranspose_*`` (the U-Net decoder) require a name-matched file,
   because conv/transpose interleaving cannot be recovered from an
   anonymous file.  Counts and shapes must match exactly.

Layout facts used:
- Keras Conv3D kernels are ``(kd, kh, kw, cin, cout)`` — identical to the
  zoo's DHWIO ``Conv`` kernels, so no transposition is needed.
  ``ConvTranspose`` kernels are stored as-is and flagged via the file
  attr ``flypylib_tpu_layout`` (Keras' Conv3DTranspose uses a different
  kernel convention; such layers only round-trip through this module).
- Keras HDF5 weight files nest as ``/<layer>/<layer>/kernel:0`` (legacy
  ``model_weights/<layer>/...`` for full-model saves); BatchNorm stores
  ``gamma/beta/moving_mean/moving_variance`` which map onto
  ``params.BatchNorm_i.scale/bias`` + ``batch_stats.BatchNorm_i.mean/var``.
"""

from __future__ import annotations

import re

import numpy as np

_BN_MAP = {
    # Keras weight name -> (collection, leaf)
    "gamma": ("params", "scale"),
    "beta": ("params", "bias"),
    "moving_mean": ("batch_stats", "mean"),
    "moving_variance": ("batch_stats", "var"),
}


def _natural_key(s: str):
    """Sort key splitting digit runs so layer_10 > layer_2."""
    return [
        int(tok) if tok.isdigit() else tok
        for tok in re.split(r"(\d+)", s)
    ]


def _strip_suffix(name: str) -> str:
    return name.split(":")[0]


def _collect_layers(f) -> list[tuple[str, dict]]:
    """[(layer_name, {weight_name: array})] in file layer order."""
    import h5py

    root = f["model_weights"] if "model_weights" in f else f
    order = root.attrs.get("layer_names")
    if order is not None:
        names = [n.decode() if isinstance(n, bytes) else n for n in order]
    else:
        # natural sort: "layer_10" must come after "layer_2" (h5py key
        # order is alphabetical, which would silently permute layers for
        # nets with >= 10 same-shape convs)
        names = sorted(root.keys(), key=_natural_key)
    out = []
    for name in names:
        grp = root[name]
        # legacy keras nests group name twice
        inner = grp[name] if name in grp else grp
        weights = {
            _strip_suffix(k): np.asarray(inner[k])
            for k in inner.keys()
            if isinstance(inner[k], h5py.Dataset)
        }
        if weights:
            out.append((name, weights))
    return out


def _layer_kind(weights: dict) -> str:
    if "gamma" in weights or "moving_mean" in weights:
        return "batchnorm"
    if "kernel" in weights and weights["kernel"].ndim == 5:
        return "conv"
    return "other"


def _check_shape(name, src, dst):
    if tuple(src.shape) != tuple(np.asarray(dst).shape):
        raise ValueError(
            f"{name}: file weight shape {tuple(src.shape)} != model "
            f"{tuple(np.asarray(dst).shape)}"
        )


def _assign_conv(new_params, name, weights, target):
    kernel = weights["kernel"]
    _check_shape(name, kernel, target["kernel"])
    bias = weights.get("bias")
    if bias is None:
        bias = np.zeros(kernel.shape[-1], np.float32)
    _check_shape(name, bias, target["bias"])
    dt = np.asarray(target["kernel"]).dtype
    new_params[name] = {
        "kernel": kernel.astype(dt), "bias": bias.astype(dt)
    }


def _assign_bn(new_params, new_stats, name, weights, p_tgt, s_tgt):
    missing = [k for k in _BN_MAP if k not in weights]
    if missing:
        raise ValueError(f"{name}: BatchNorm file group missing {missing}")
    np_, ns_ = dict(p_tgt), dict(s_tgt)
    for wname, (coll, leaf) in _BN_MAP.items():
        tgt = p_tgt if coll == "params" else s_tgt
        _check_shape(f"{name}/{wname}", weights[wname], tgt[leaf])
        dst = np_ if coll == "params" else ns_
        dst[leaf] = weights[wname].astype(np.asarray(tgt[leaf]).dtype)
    new_params[name] = np_
    new_stats[name] = ns_


def load_keras_variables(path: str, variables: dict) -> dict:
    """Fill a zoo variables pytree (``{"params": ..., "batch_stats"?}``)
    from a Keras HDF5 weight file.  See module docstring for the
    layer-mapping contract; any unmatched weight raises."""
    import h5py

    with h5py.File(path, "r") as f:
        layers = _collect_layers(f)

    params = variables["params"]
    stats = variables.get("batch_stats", {}) or {}
    model_convs = sorted(
        (k for k in params
         if k.startswith("Conv") or k.startswith("ConvTranspose")),
        key=_natural_key,
    )
    model_bns = sorted(
        (k for k in params if k.startswith("BatchNorm")), key=_natural_key
    )

    by_name = all(
        name in params or name in stats for name, _ in layers
    ) and len(layers) > 0

    new_params, new_stats = dict(params), dict(stats)
    filled = set()
    if by_name:
        for name, weights in layers:
            kind = _layer_kind(weights)
            if kind == "conv":
                if name not in params:
                    raise ValueError(f"{name}: not a conv layer in model")
                _assign_conv(new_params, name, weights, params[name])
            elif kind == "batchnorm":
                if name not in params or name not in stats:
                    raise ValueError(
                        f"{name}: model has no BatchNorm layer/stats "
                        f"under this name"
                    )
                _assign_bn(new_params, new_stats, name, weights,
                           params[name], stats[name])
            else:
                raise ValueError(
                    f"{name}: unrecognized layer contents "
                    f"{sorted(weights)}"
                )
            filled.add(name)
    else:
        file_convs = [(n, w) for n, w in layers
                      if _layer_kind(w) == "conv"]
        file_bns = [(n, w) for n, w in layers
                    if _layer_kind(w) == "batchnorm"]
        leftover = [n for n, w in layers
                    if _layer_kind(w) not in ("conv", "batchnorm")]
        if leftover:
            raise ValueError(
                f"unrecognized layers in weight file: {leftover}"
            )
        if any(k.startswith("ConvTranspose") for k in model_convs):
            raise ValueError(
                "model contains ConvTranspose layers; order-based import "
                "cannot recover conv/transpose interleaving — use a "
                "name-matched file (save_keras_weights writes one)"
            )
        if len(file_convs) != len(model_convs):
            raise ValueError(
                f"layer count mismatch: file has {len(file_convs)} conv "
                f"layers, model has {len(model_convs)}"
            )
        if len(file_bns) != len(model_bns):
            raise ValueError(
                f"BatchNorm count mismatch: file has {len(file_bns)}, "
                f"model has {len(model_bns)}"
            )
        for (fname, weights), mname in zip(file_convs, model_convs):
            _assign_conv(new_params, mname, weights, params[mname])
            filled.add(mname)
        for (fname, weights), mname in zip(file_bns, model_bns):
            _assign_bn(new_params, new_stats, mname, weights,
                       params[mname], stats[mname])
            filled.add(mname)

    unfilled = [k for k in (*model_convs, *model_bns) if k not in filled]
    if unfilled:
        raise ValueError(
            f"model layers not present in weight file: {unfilled}"
        )
    out = {"params": new_params}
    if new_stats:
        out["batch_stats"] = new_stats
    return out


def load_keras_weights(path: str, params: dict) -> dict:
    """Back-compat wrapper: fill a params pytree (no batch_stats) from a
    Keras HDF5 weight file.  Raises if the file carries BatchNorm state
    (use :func:`load_keras_variables` then)."""
    import h5py

    with h5py.File(path, "r") as f:
        has_bn = any(
            _layer_kind(w) == "batchnorm" for _, w in _collect_layers(f)
        )
    if has_bn:
        raise ValueError(
            "weight file contains BatchNorm layers; call "
            "load_keras_variables with the full variables pytree"
        )
    return load_keras_variables(path, {"params": params})["params"]


def save_keras_weights(path: str, variables: dict) -> None:
    """Write zoo weights as a Keras-compatible HDF5 weight file, layer
    names = the variables tree's layer names (round-trip partner of
    :func:`load_keras_variables`).  ``variables`` may be a full
    ``{"params", "batch_stats"}`` pytree or a bare params dict."""
    if "params" in variables and isinstance(variables["params"], dict):
        params = variables["params"]
        stats = variables.get("batch_stats", {}) or {}
    else:
        params, stats = variables, {}
    conv_names = sorted(
        (k for k in params
         if k.startswith("Conv") or k.startswith("ConvTranspose")),
        key=_natural_key,
    )
    bn_names = sorted(
        (k for k in params if k.startswith("BatchNorm")), key=_natural_key
    )
    names = conv_names + bn_names
    import h5py

    with h5py.File(path, "w") as f:
        f.attrs["layer_names"] = np.array([n.encode() for n in names])
        # layout tag, unchanged since the first files were written
        f.attrs["flypylib_tpu_layout"] = "flax"
        for name in conv_names:
            grp = f.create_group(name).create_group(name)
            grp.create_dataset(
                "kernel:0", data=np.asarray(params[name]["kernel"])
            )
            grp.create_dataset(
                "bias:0", data=np.asarray(params[name]["bias"])
            )
        for name in bn_names:
            grp = f.create_group(name).create_group(name)
            grp.create_dataset(
                "gamma:0", data=np.asarray(params[name]["scale"])
            )
            grp.create_dataset(
                "beta:0", data=np.asarray(params[name]["bias"])
            )
            grp.create_dataset(
                "moving_mean:0", data=np.asarray(stats[name]["mean"])
            )
            grp.create_dataset(
                "moving_variance:0", data=np.asarray(stats[name]["var"])
            )
