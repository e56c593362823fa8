"""The reference-PaddlePaddle binary checkpoint format, both ways (port of
``paddle_tpu.framework.paddle_export`` and ``paddle_import``): what
``fluid.io``'s save / load functions write and read, in the files both
packages read.

* A LoDTensor stream (``lod_tensor.cc:243 SerializeToStream``):
  ``u32 version(0)`` · ``u64 lod_level`` (+ per level ``u64 nbytes`` and
  the offsets) · ``u32 version(0)`` · ``i32 desc_size`` ·
  ``VarType.TensorDesc`` protobuf · raw row-major bytes.
* ``save_params`` / ``save_persistables``: one file a variable named by
  it, or with ``filename`` ONE stream of the tensors in SORTED name order
  (``fluid/io.py:344``), beside a ``__model__`` ProgramDesc that declares
  the persistables (their names, program order, dtypes, shapes).
* ``save_inference_model``'s layout (``save_reference_inference_model``):
  the same ``__model__`` with the feed / fetch plumbing, and the params.

The protobuf wire format is walked and emitted directly (varints and
length-delimited fields with ``framework.proto``'s field numbers).  A
bfloat16 tensor is written as BF16 (code 22) from its bits and read back
as a ``torch.bfloat16`` tensor (numpy has no bfloat16 here); every other
value is a numpy array.  ``adapt_state_dict`` maps such a state onto a
Layer's names (exact names, then 1.x builder roles and shapes in program
order).
"""
from __future__ import annotations

import os
import re
import struct
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from .errors import InvalidArgumentError

__all__ = ["write_lod_tensor_stream", "build_program_desc",
           "save_reference_state", "save_reference_inference_model",
           "read_lod_tensor_stream",
           "parse_program_persistables", "load_reference_state_dict",
           "adapt_state_dict"]

# framework.proto:105 VarType.Type of each numpy dtype (and BF16 = 22)
_DTYPE_CODES = {
    np.dtype(np.bool_): 0, np.dtype(np.int16): 1, np.dtype(np.int32): 2,
    np.dtype(np.int64): 3, np.dtype(np.float16): 4,
    np.dtype(np.float32): 5, np.dtype(np.float64): 6,
    np.dtype(np.uint64): 19, np.dtype(np.uint8): 20, np.dtype(np.int8): 21,
}
_BF16 = "bfloat16"  # numpy has no bfloat16 here: a marker
_LOD_TENSOR = 7
_FEED_MINIBATCH = 9
_FETCH_LIST = 10


def _dtype_code(dt) -> int:
    if isinstance(dt, str) and dt == _BF16:
        return 22
    code = _DTYPE_CODES.get(np.dtype(dt))
    if code is None:
        raise InvalidArgumentError(
            f"dtype {dt} has no VarType.Type code in the reference format")
    return code


# ---------------------------------------------------------------------------
# protobuf wire encoding (proto2; only what the format needs)
# ---------------------------------------------------------------------------
def _enc_varint(v: int) -> bytes:
    if v < 0:  # two's complement int64/int32, sign-extended (10 bytes)
        v += 1 << 64
    out = bytearray()
    while True:
        b = v & 0x7F
        v >>= 7
        if v:
            out.append(b | 0x80)
        else:
            out.append(b)
            return bytes(out)


def _field_varint(fno: int, v: int) -> bytes:
    return _enc_varint(fno << 3) + _enc_varint(v)


def _field_bytes(fno: int, payload: bytes) -> bytes:
    return _enc_varint((fno << 3) | 2) + _enc_varint(len(payload)) + payload


def _tensor_desc(dtype, shape) -> bytes:
    # TensorDesc: data_type=1 (enum), dims=2 (repeated int64, unpacked —
    # proto2 default, and what the reference's C++ emits)
    out = _field_varint(1, _dtype_code(dtype))
    for d in shape:
        out += _field_varint(2, int(d))
    return out


def _var_type(kind: int, dtype=None, shape=None) -> bytes:
    # VarType: type=1; lod_tensor=3 {tensor=1 TensorDesc} for LOD_TENSOR
    out = _field_varint(1, kind)
    if kind == _LOD_TENSOR:
        out += _field_bytes(3, _field_bytes(1, _tensor_desc(dtype, shape)))
    return out


def _var_desc(name: str, kind: int, dtype=None, shape=None,
              persistable: bool = False) -> bytes:
    out = _field_bytes(1, name.encode())
    out += _field_bytes(2, _var_type(kind, dtype, shape))
    if persistable:
        out += _field_varint(3, 1)
    return out


def _op_var(parameter: str, arguments: Sequence[str]) -> bytes:
    out = _field_bytes(1, parameter.encode())
    for a in arguments:
        out += _field_bytes(2, a.encode())
    return out


def _op_attr_int(name: str, value: int) -> bytes:
    # Attr: name=1, type=2 (INT=0), i=3
    return (_field_bytes(1, name.encode()) + _field_varint(2, 0)
            + _field_varint(3, value))


def _op_desc(op_type: str, inputs, outputs, attrs=()) -> bytes:
    out = b""
    for param, args in inputs:
        out += _field_bytes(1, _op_var(param, args))
    for param, args in outputs:
        out += _field_bytes(2, _op_var(param, args))
    out += _field_bytes(3, op_type.encode())
    for a in attrs:
        out += _field_bytes(4, a)
    return out


def build_program_desc(var_specs: Sequence[dict],
                       feed_names: Sequence[str] = (),
                       fetch_names: Sequence[str] = ()) -> bytes:
    """Serialize a ProgramDesc declaring ``var_specs``
    (``[{"name", "shape", "dtype", "persistable"?}]``) plus the standard
    feed/fetch plumbing (``fluid/io.py:1164 prepend_feed_ops /
    append_fetch_ops``).  Decodes cleanly with
    ``protoc --decode paddle.framework.proto.ProgramDesc framework.proto``.
    """
    # root block: idx=0, parent_idx=kNoneBlockIndex=-1 (proto_desc.h:23)
    block = _field_varint(1, 0) + _field_varint(2, -1)
    for spec in var_specs:
        block += _field_bytes(3, _var_desc(
            spec["name"], _LOD_TENSOR, spec["dtype"], spec["shape"],
            persistable=bool(spec.get("persistable", True))))
    ops = b""
    if feed_names or fetch_names:
        block += _field_bytes(3, _var_desc("feed", _FEED_MINIBATCH,
                                           persistable=True))
        block += _field_bytes(3, _var_desc("fetch", _FETCH_LIST,
                                           persistable=True))
        for i, name in enumerate(feed_names):
            ops += _field_bytes(4, _op_desc(
                "feed", [("X", ["feed"])], [("Out", [name])],
                [_op_attr_int("col", i)]))
        for i, name in enumerate(fetch_names):
            ops += _field_bytes(4, _op_desc(
                "fetch", [("X", [name])], [("Out", ["fetch"])],
                [_op_attr_int("col", i)]))
    block += ops
    # ProgramDesc: blocks=1, version=4 {version=1}
    return (_field_bytes(1, block)
            + _field_bytes(4, _field_varint(1, 0)))


# ---------------------------------------------------------------------------
# writing
# ---------------------------------------------------------------------------
def _host(v):
    """``(dtype or "bfloat16", shape, raw bytes)`` of a tensor or array."""
    if isinstance(v, torch.Tensor):
        t = v.detach().cpu().contiguous()
        if t.dtype == torch.bfloat16:
            raw = t.view(torch.int16).numpy().tobytes()
            return _BF16, tuple(t.shape), raw
        v = t.numpy()
    a = np.ascontiguousarray(np.asarray(v))
    return a.dtype, a.shape, a.tobytes()


def write_lod_tensor_stream(f, value) -> None:
    """One LoDTensor stream (LoD level 0: dense padding replaces LoD)."""
    dtype, shape, raw = _host(value)
    f.write(struct.pack("<I", 0))           # LoDTensor version
    f.write(struct.pack("<Q", 0))           # lod_level = 0
    f.write(struct.pack("<I", 0))           # Tensor version
    desc = _tensor_desc(dtype, shape)
    f.write(struct.pack("<i", len(desc)))
    f.write(desc)
    f.write(raw)


def save_reference_state(state, dirname: str,
                         filename: Optional[str] = None,
                         model_filename: str = "__model__") -> None:
    """Per-variable files, or one combined file in sorted-name order when
    ``filename`` is given, beside a ``__model__`` ProgramDesc naming the
    variables in ``state``'s order."""
    os.makedirs(dirname, exist_ok=True)
    with open(os.path.join(dirname, model_filename), "wb") as f:
        f.write(build_program_desc(_state_specs(state)))
    _write_params(state, dirname, filename)


def _state_specs(state):
    specs = []
    for n, v in state.items():
        dtype, shape, _ = _host(v)
        specs.append({"name": n, "shape": shape, "dtype": dtype})
    return specs


def _write_params(state, dirname: str, filename: Optional[str]) -> None:
    if filename is None:
        for name, v in state.items():
            if os.sep in name or (os.altsep and os.altsep in name):
                raise InvalidArgumentError(
                    f"variable name {name!r} is not a valid filename for "
                    "per-variable save; pass filename= for a combined file")
            with open(os.path.join(dirname, name), "wb") as f:
                write_lod_tensor_stream(f, v)
    else:
        with open(os.path.join(dirname, filename), "wb") as f:
            for name in sorted(state):  # fluid/io.py:344 sorted-name order
                write_lod_tensor_stream(f, state[name])


def save_reference_inference_model(
        dirname: str, feed_names: Sequence[str],
        fetch_names: Sequence[str], state,
        model_filename: str = "__model__",
        params_filename: Optional[str] = None) -> None:
    """The reference's ``save_inference_model`` layout (``fluid/io.py:
    1164``): ``__model__`` declaring the persistables with the feed /
    fetch plumbing (the ``feed`` / ``fetch`` variables and one op a
    name), and the params per variable or combined (``params_filename``,
    sorted-name order)."""
    os.makedirs(dirname, exist_ok=True)
    with open(os.path.join(dirname, model_filename), "wb") as f:
        f.write(build_program_desc(_state_specs(state),
                                   feed_names=feed_names,
                                   fetch_names=fetch_names))
    _write_params(state, dirname, params_filename)


# framework.proto:105 VarType.Type → numpy dtype (22: BF16)
_DTYPES = {code: dt for dt, code in _DTYPE_CODES.items()}
_LOD_TENSOR_TYPE = 7  # VarType.Type.LOD_TENSOR


# ---------------------------------------------------------------------------
# reading: protobuf wire-format walking (proto2; what the format needs)
# ---------------------------------------------------------------------------
def _varint(buf: bytes, i: int) -> Tuple[int, int]:
    shift = val = 0
    while True:
        b = buf[i]
        i += 1
        val |= (b & 0x7F) << shift
        if not b & 0x80:
            return val, i
        shift += 7


def _fields(buf: bytes) -> Dict[int, list]:
    """Walk one serialized message: {field_number: [raw values]} where a
    raw value is an int (varint/fixed) or bytes (length-delimited)."""
    out: Dict[int, list] = {}
    i = 0
    while i < len(buf):
        key, i = _varint(buf, i)
        fno, wire = key >> 3, key & 7
        if wire == 0:
            v, i = _varint(buf, i)
        elif wire == 1:
            v = struct.unpack_from("<q", buf, i)[0]
            i += 8
        elif wire == 2:
            n, i = _varint(buf, i)
            v = buf[i:i + n]
            i += n
        elif wire == 5:
            v = struct.unpack_from("<i", buf, i)[0]
            i += 4
        else:
            raise InvalidArgumentError(f"unsupported wire type {wire}")
        out.setdefault(fno, []).append(v)
    return out


def _repeated_int64(raw_list) -> List[int]:
    """proto2 repeated int64: unpacked (one varint per entry) or packed
    (one length-delimited blob)."""
    dims: List[int] = []
    for v in raw_list:
        if isinstance(v, bytes):  # packed
            i = 0
            while i < len(v):
                d, i = _varint(v, i)
                dims.append(d)
        else:
            dims.append(v)
    # dims are int64 two's complement via varint (−1 = UNK batch)
    return [d - (1 << 64) if d >= (1 << 63) else d for d in dims]


def _read_tensor_desc(desc_bytes: bytes):
    f = _fields(desc_bytes)
    code = f[1][0]
    dt = _BF16 if code == 22 else _DTYPES.get(code)
    if dt is None:
        raise InvalidArgumentError(f"unsupported tensor dtype code {code}")
    return dt, tuple(_repeated_int64(f.get(2, [])))


def parse_program_persistables(model_bytes: bytes) -> List[dict]:
    """Block-0 persistable LoDTensor variables of a serialized ProgramDesc,
    in program order: [{"name", "shape", "dtype"}].  Feed/fetch plumbing
    is excluded (their VarType is not LOD_TENSOR)."""
    prog = _fields(model_bytes)
    if 1 not in prog:
        raise InvalidArgumentError(
            "not a ProgramDesc: no blocks field (is this really a "
            "__model__ / .pdmodel file?)")
    block0 = _fields(prog[1][0])
    out = []
    for raw_var in block0.get(3, []):
        var = _fields(raw_var)
        name = var[1][0].decode()
        persistable = bool(var.get(3, [0])[0])
        vtype = _fields(var[2][0])
        type_code = vtype.get(1, [None])[0]
        if not persistable or type_code != _LOD_TENSOR_TYPE:
            continue
        lod_desc = _fields(vtype[3][0])      # LoDTensorDesc
        np_dt, dims = _read_tensor_desc(lod_desc[1][0])
        out.append({"name": name, "shape": dims, "dtype": np_dt})
    return out


def read_lod_tensor_stream(f):
    """One LoDTensor from a binary stream: a numpy array, or a
    ``torch.bfloat16`` tensor for BF16."""
    ver = struct.unpack("<I", f.read(4))[0]
    if ver != 0:
        raise InvalidArgumentError(f"unsupported LoDTensor version {ver}")
    for _ in range(struct.unpack("<Q", f.read(8))[0]):
        f.read(struct.unpack("<Q", f.read(8))[0])  # LoD offsets: dropped
    ver = struct.unpack("<I", f.read(4))[0]
    if ver != 0:
        raise InvalidArgumentError(f"unsupported Tensor version {ver}")
    desc_size = struct.unpack("<i", f.read(4))[0]
    dt, dims = _read_tensor_desc(f.read(desc_size))
    numel = int(np.prod(dims)) if dims else 1
    item = 2 if isinstance(dt, str) else np.dtype(dt).itemsize
    data = f.read(numel * item)
    if len(data) != numel * item:
        raise InvalidArgumentError("truncated tensor data")
    if isinstance(dt, str):
        return torch.from_numpy(np.frombuffer(data, np.int16).copy()).view(
            torch.bfloat16).reshape(dims)
    return np.frombuffer(data, dt).reshape(dims).copy()


def load_reference_state_dict(
        path: str, params_filename: Optional[str] = None,
        model_filename: str = "__model__") -> Dict[str, np.ndarray]:
    """Load a reference-Paddle checkpoint into {name: ndarray}.

    ``path`` may be:
    * a directory of per-variable files (``save_params`` default mode) —
      optionally containing ``__model__``/``*.pdmodel``, used (when
      present) to restrict to that program's persistables;
    * a directory with a COMBINED params file (pass ``params_filename``,
      e.g. ``save_inference_model(..., params_filename="params")``);
    * a single combined file — needs its ``__model__``/``.pdmodel``
      sibling for names;
    * a 2.x pickled ``.pdparams`` state dict.
    """
    # 2.x pickled state dict?
    if os.path.isfile(path):
        with open(path, "rb") as f:
            head = f.read(2)
        if head[:1] == b"\x80":  # pickle protocol marker
            import pickle

            with open(path, "rb") as f:
                sd = pickle.load(f)
            # drop the reference's metadata tables (e.g.
            # 'StructuredToParameterName@@', framework/io.py:48) — anything
            # that isn't array-like is bookkeeping, not a parameter
            return {k: np.asarray(v) for k, v in sd.items()
                    if not str(k).endswith("@@")
                    and not isinstance(v, (dict, str))}
        model = None
        for cand in (os.path.join(os.path.dirname(path), model_filename),
                     os.path.splitext(path)[0] + ".pdmodel"):
            if os.path.exists(cand):
                model = cand
                break
        if model is None:
            raise InvalidArgumentError(
                "combined params file needs its __model__/.pdmodel sibling "
                "for variable names (fluid/io.py:344 sorted-name order)")
        return _load_combined(path, model)

    if not os.path.isdir(path):
        raise InvalidArgumentError(f"no such checkpoint path: {path}")

    if params_filename is not None:
        return _load_combined(os.path.join(path, params_filename),
                              os.path.join(path, model_filename))

    # per-variable files: every regular file that parses as a LoDTensor.
    # With a __model__, iterate in PROGRAM (creation) order — structural
    # matching in adapt_state_dict relies on it (the reference's builder
    # names encode creation order the same way)
    out: Dict[str, np.ndarray] = {}
    order = None
    model_path = os.path.join(path, model_filename)
    if os.path.exists(model_path):
        with open(model_path, "rb") as f:
            order = [v["name"] for v in parse_program_persistables(f.read())]
    fnames = (order if order is not None
              else sorted(os.listdir(path)))
    for fname in fnames:
        fpath = os.path.join(path, fname)
        if order is not None and not os.path.isfile(fpath):
            raise InvalidArgumentError(
                f"__model__ lists variable {fname!r} but the file is "
                f"missing from {path} — truncated/partial checkpoint")
        if not os.path.isfile(fpath) or fname == model_filename \
                or fname.endswith((".pdmodel", ".py")):
            continue
        try:
            with open(fpath, "rb") as f:
                out[fname] = read_lod_tensor_stream(f)
        except (InvalidArgumentError, struct.error, KeyError, IndexError,
                ValueError):
            if order is not None:  # the program said it should parse
                raise
            continue  # directory stray, skip
    if not out:
        raise InvalidArgumentError(
            f"no persistable tensors found under {path}")
    return out


def _load_combined(params_path: str, model_path: str) -> Dict[str, np.ndarray]:
    with open(model_path, "rb") as f:
        varinfo = parse_program_persistables(f.read())
    order = [v["name"] for v in varinfo]
    names = sorted(order)  # file layout: fluid/io.py:344,873 sorted order
    out = {}
    with open(params_path, "rb") as f:
        for name in names:
            out[name] = read_lod_tensor_stream(f)
        tail = f.read(1)
    if tail:
        raise InvalidArgumentError(
            "combined params file has trailing bytes — the __model__ "
            "variable list does not match the file")
    # expose PROGRAM (creation) order to structural matching
    return {name: out[name] for name in order}


# ---------------------------------------------------------------------------
# mapping onto a Layer
# ---------------------------------------------------------------------------
# the 1.x builder role suffixes (``conv2d_0.w_0`` …): w_0=weight/scale,
# b_0=bias, w_1/w_2=BN moving mean/variance (fluid/layers/nn.py batch_norm
# default names) ↔ this framework's 2.0 attribute names
_ROLE_BY_ATTR = {"weight": "w_0", "bias": "b_0",
                 "_mean": "w_1", "_variance": "w_2"}
_1X_ROLE = re.compile(r"\.([wb]_\d+)$")


def _natural_key(name: str):
    return [int(t) if t.isdigit() else t
            for t in re.split(r"(\d+)", name)]


def adapt_state_dict(sd: Dict[str, np.ndarray], layer) -> Dict[str, np.ndarray]:
    """Map imported names onto ``layer.state_dict()`` names.

    1. Exact name matches (the 2.0 zoo's dotted names match the
       port's layers).
    2. STRUCTURAL matching for renamed 1.x builder params
       (``conv2d_0.w_0``, …): leftovers are grouped by
       ``(shape, role)`` — role parsed from the 1.x suffix on the source
       side and from the attribute name on the target side — and each
       group is zipped in ORDER: target order is the layer's traversal
       order, source order is the checkpoint's PROGRAM (creation) order
       when a ``__model__`` provided it (load_reference_state_dict
       preserves it), else natural-sorted names (``conv2d_2`` before
       ``conv2d_10``).  Repeated same-shape params (ResNet's 3×3 stacks,
       BERT's identical blocks) disambiguate by this order — the two
       sides walk the same architecture.
    3. Raises when a group's sizes differ or targets stay unmatched.
    """
    target = layer.state_dict()
    remaining = dict(sd)
    out: Dict[str, np.ndarray] = {}
    unmatched = []
    for name, val in target.items():
        if name in remaining:
            out[name] = remaining.pop(name)
        else:
            unmatched.append(name)
    if not unmatched:
        return out

    use_roles = all(_1X_ROLE.search(n) for n in remaining)

    def src_key(name):
        shape = tuple(remaining[name].shape)
        if not use_roles:
            return (shape,)
        return (shape, _1X_ROLE.search(name).group(1))

    def tgt_key(name):
        shape = tuple(np.shape(target[name]))
        if not use_roles:
            return (shape,)
        attr = name.rsplit(".", 1)[-1]
        role = _ROLE_BY_ATTR.get(attr)
        if role is None:
            # unknown attribute (e.g. a custom buffer): its own bucket —
            # matched only by an exactly-equal source role never produced
            # by the map, so it surfaces as unmatched with a clear error
            role = f"?{attr}"
        return (shape, role)

    src_names = list(remaining)
    if not _is_program_ordered(sd):
        src_names.sort(key=_natural_key)

    def run_pass(skey, tkey):
        problems = []
        src_groups: Dict[tuple, list] = {}
        for n in src_names:
            if n in remaining:
                src_groups.setdefault(skey(n), []).append(n)
        tgt_groups: Dict[tuple, list] = {}
        for n in unmatched:  # state_dict traversal order
            tgt_groups.setdefault(tkey(n), []).append(n)
        for key, tnames in tgt_groups.items():
            snames = src_groups.get(key, [])
            if len(snames) != len(tnames):
                problems.append(
                    f"{key}: {len(tnames)} targets vs {len(snames)} imports")
                continue
            for tn, sn in zip(tnames, snames):
                out[tn] = remaining.pop(sn)
                unmatched.remove(tn)
        return problems

    shape_skey = lambda n: (tuple(remaining[n].shape),)  # noqa: E731
    shape_tkey = lambda n: (tuple(np.shape(target[n])),)  # noqa: E731
    problems = run_pass(src_key if use_roles else shape_skey,
                        tgt_key if use_roles else shape_tkey)
    if unmatched and use_roles:
        # roles that don't line up (hand-renamed checkpoints) retry on
        # shape alone — the pre-r5 behavior, generalized to ordered groups
        problems = run_pass(shape_skey, shape_tkey)
    if unmatched:
        raise InvalidArgumentError(
            f"could not map imported params onto {unmatched[:5]}… "
            f"({len(unmatched)} unmatched; {len(remaining)} unused imports "
            f"{list(remaining)[:5]}…; group mismatches: {problems[:4]})")
    return out


def _is_program_ordered(sd) -> bool:
    """Heuristic: load_reference_state_dict preserves program order when a
    __model__ described the checkpoint; a dict in sorted-name order was
    more likely assembled without one (alphabetical ≠ creation order for
    two-digit indices — conv2d_10 sorts before conv2d_2)."""
    names = list(sd)
    return names != sorted(names)
