"""Inference export and serving — the saved-module path (port of
``paddle_tpu.inference``).

Parity: the reference's inference stack — ``save_inference_model``
(python/paddle/fluid/io.py:1164: prune the train Program to feed → fetch,
save ``__model__`` + params) and the C++ AnalysisPredictor
(paddle/fluid/inference/api/analysis_predictor.h:82: load, optimise,
execute).

Design: the eval-mode forward is traced once by ``torch.export`` as the
function ``(params, buffers, *inputs) → outputs`` over
``torch.func.functional_call`` (batch-polymorphic through
``torch.export.Dim``s of one scope, ``static.make_symbols``), so the
``.pdmodel`` carries the graph and no weight bytes.  The hand kernels on
the path are custom operators of the ``paddle_tpu_torch`` namespace
(``layernorm_residual_fwd``, ``flash_attention_fwd``,
``quantized_matmul``): the graph keeps them whole, and at run time each
launches its CUDA kernel on a card tensor and runs its plain version on a
CPU tensor.

Files written for prefix ``P``:
  P.pdmodel    — the port's magic, a u32 header length, the meta JSON
                 (``format_version``, ``platforms``, ``inputs``,
                 ``n_outputs``, and the ``params`` / ``buffers`` signature),
                 then a ``torch.export.save`` of the ``ExportedProgram``
  P.pdiparams  — ``{"params": {dotted name: array}, "buffers": ...}`` in
                 the checkpoint format both packages read
                 (``framework/serialization``), so a ``.pdiparams`` the JAX
                 package wrote loads here too (``params_file=`` or
                 ``swap_weights``)

The two packages' ``.pdmodel`` payloads are not interchangeable
(StableHLO against ``torch.export``): each refuses the other's magic.

``platforms`` lists where an artifact may serve: ``"gpu"`` (a CUDA card)
and ``"cpu"``.  An export with ``"gpu"`` traces with the weights on the
card, so the card's routes (the flash gate of ``models.gpt``) are in the
graph; its device constants are moved to the serving device at load, and
on the CPU its operators run their plain versions.  The default is
``("cpu", "gpu")`` for a layer that lives on a card and ``("cpu",)`` for
one on the CPU (the caller asked for the CPU).  A ``Predictor`` refuses a
device whose platform the artifact does not list.
"""
from __future__ import annotations

import io
import itertools
import json
import os
import struct
import threading
from typing import List, Optional, Sequence

import numpy as np
import torch
import torch.utils._pytree as pytree

from .. import ops  # noqa: F401  (registers the operators graphs call)
from ..framework import serialization
from ..framework.device import resolve_device
from ..framework.dtype import convert_dtype, numpy_to_tensor, to_numpy
from ..framework.errors import (InvalidArgumentError, NotFoundError,
                                UnimplementedError)
from ..nn.layer import functional_call
from ..static import InputSpec, make_symbols

__all__ = [
    "save_inference_model",
    "load_inference_model",
    "Config",
    "Predictor",
    "create_predictor",
]

_MAGIC = b"PTTHIM01"
#: the JAX package's magic (``paddle_tpu.inference``): a StableHLO payload
_JAX_MAGIC = b"PTPUIM01"
_PLATFORMS = ("cpu", "gpu")
_ITEM8 = "static graph and the long tail"


def _as_input_specs(input_spec) -> List[InputSpec]:
    specs = []
    for i, s in enumerate(input_spec):
        if isinstance(s, InputSpec):
            specs.append(s if s.name else InputSpec(s.shape, s.dtype, f"x{i}"))
        elif hasattr(s, "shape") and hasattr(s, "dtype"):
            specs.append(InputSpec.from_tensor(s, name=f"x{i}"))
        else:
            raise InvalidArgumentError(
                f"input_spec[{i}] must be an InputSpec or tensor, got "
                f"{type(s).__name__}")
    return specs


def _dtype_name(dtype: torch.dtype) -> str:
    return str(dtype).replace("torch.", "")


def _platform(device: torch.device) -> str:
    return "gpu" if device.type == "cuda" else "cpu"


def _layer_device(layer) -> torch.device:
    """Where the layer's tensors live (its first parameter's or, for a
    layer of buffers only such as an int8 one, its first buffer's device);
    the CPU for a layer without tensors."""
    own = next(itertools.chain(layer.parameters(), layer.buffers()), None)
    return torch.device("cpu") if own is None else own.device


def _trace_device(layer, platforms) -> torch.device:
    """Where the export traces: the layer's card when ``"gpu"`` is listed
    (the default card when the layer lives on the CPU: no card raises
    ``UnavailableError``), else the CPU."""
    if "gpu" not in platforms:
        return torch.device("cpu")
    own = _layer_device(layer)
    return own if own.type == "cuda" else resolve_device("cuda")


class _Forward(torch.nn.Module):
    """``(params, buffers, *inputs) → flat outputs`` of ``layer`` in eval
    mode.  The layer is not registered as a submodule, so none of its
    tensors is lifted into the export: the weights are inputs."""

    def __init__(self, layer):
        super().__init__()
        self.__dict__["_layer"] = layer

    def forward(self, params, buffers, *inputs):
        out = functional_call(self._layer, params, *inputs, buffers=buffers,
                              training=False)
        return tuple(pytree.tree_leaves(out))


def _examples(specs, device):
    """One zero tensor a spec, each dynamic size a distinct prime from 2
    up (a shared symbol gets one size), and the ``dynamic_shapes`` entry
    of each."""
    symbols = make_symbols(specs)
    primes = [2, 3, 5, 7, 11, 13, 17, 19, 23, 29, 31, 37, 41, 43, 47]
    if len(symbols) > len(primes):
        raise InvalidArgumentError(
            f"an export takes at most {len(primes)} symbolic dims, got "
            f"{len(symbols)}")
    sizes = dict(zip(symbols, primes))
    examples, dyn = [], []
    for s in specs:
        names = iter(s.symbol_names())
        shape = [d if isinstance(d, int) else sizes[next(names)]
                 for d in s.shape]
        examples.append(torch.zeros(shape, dtype=s.dtype, device=device))
        dyn.append(s.dynamic_shape(symbols) or None)
    return examples, tuple(dyn)


def save_inference_model(
    path_prefix: str,
    layer,
    input_spec: Sequence,
    *,
    platforms: Optional[Sequence[str]] = None,
) -> str:
    """Export ``layer``'s eval-mode forward (``P.pdmodel``) and its weights
    (``P.pdiparams``).

    ``input_spec``: one InputSpec (or example tensor) per forward input;
    ``None`` / -1 dims are batch-polymorphic, a string dim a named size
    shared by every spec that names it.  ``platforms``: see the module
    docstring.  The layer's training flag is restored.  A forward whose
    Python control flow depends on tensor values does not export (there is
    no dy2static transpiler yet): ``UnimplementedError``."""
    from torch._subclasses.fake_tensor import DataDependentOutputException
    from torch.fx.experimental.symbolic_shapes import (
        GuardOnDataDependentSymNode)

    if not isinstance(layer, torch.nn.Module):
        raise InvalidArgumentError("save_inference_model expects a Layer")
    specs = _as_input_specs(input_spec)
    if platforms is None:
        on_card = _layer_device(layer).type == "cuda"
        platforms = _PLATFORMS if on_card else ("cpu",)
    platforms = tuple(platforms)
    unknown = [p for p in platforms if p not in _PLATFORMS]
    if unknown or not platforms:
        raise InvalidArgumentError(
            f"platforms {platforms}: the port serves on {_PLATFORMS}")
    device = _trace_device(layer, platforms)

    was_training = layer.training
    layer.eval()
    try:
        params = {n: p.detach().to(device)
                  for n, p in layer.named_parameters()}
        buffers = {n: b.detach().to(device)
                   for n, b in layer.named_buffers()}
        examples, dyn = _examples(specs, device)
        try:
            with torch.no_grad():
                ep = torch.export.export(
                    _Forward(layer), (params, buffers, *examples),
                    dynamic_shapes=({n: None for n in params},
                                    {n: None for n in buffers}, dyn),
                    strict=False)
        except (GuardOnDataDependentSymNode,
                DataDependentOutputException) as e:
            raise UnimplementedError(
                f"save_inference_model: {type(layer).__name__}'s forward "
                f"branches on a tensor's value, which needs the dy2static "
                f"transpiler (ROADMAP queue A, {_ITEM8}); no graph "
                f"specialised to one branch is exported.  Original: "
                f"{str(e).splitlines()[0]}") from e
        ep.example_inputs = None  # they hold the weights: not saved
        blob = io.BytesIO()
        torch.export.save(ep, blob)
    finally:
        if was_training:
            layer.train()

    meta = {
        "format_version": 1,
        "platforms": list(platforms),
        "inputs": [
            {"name": s.name,
             "shape": [d if isinstance(d, int) else -1 for d in s.shape],
             "dtype": _dtype_name(s.dtype)}
            for s in specs
        ],
        "n_outputs": len(ep.graph_signature.user_outputs),
        "trace_device": str(device),
        "params": [[n, list(t.shape), _dtype_name(t.dtype)]
                   for n, t in params.items()],
        "buffers": [[n, list(t.shape), _dtype_name(t.dtype)]
                    for n, t in buffers.items()],
    }
    meta_bytes = json.dumps(meta).encode()

    parent = os.path.dirname(os.path.abspath(path_prefix))
    os.makedirs(parent, exist_ok=True)
    with open(path_prefix + ".pdmodel", "wb") as f:
        f.write(_MAGIC)
        f.write(struct.pack("<I", len(meta_bytes)))
        f.write(meta_bytes)
        f.write(blob.getvalue())
    serialization.save({"params": params, "buffers": buffers},
                       path_prefix + ".pdiparams")
    return path_prefix


def _read_model_file(path: str):
    if not os.path.exists(path):
        raise NotFoundError(f"no inference model at {path}")
    with open(path, "rb") as f:
        magic = f.read(len(_MAGIC))
        if magic == _JAX_MAGIC:
            raise InvalidArgumentError(
                f"{path} is the JAX package's StableHLO artifact "
                f"(paddle_tpu.inference, magic {magic!r}); the port runs "
                f"torch.export artifacts: export the model with "
                f"paddle_tpu_torch.inference.save_inference_model (its "
                f".pdiparams loads here as params_file=)")
        if magic != _MAGIC:
            raise InvalidArgumentError(
                f"{path} is not a paddle_tpu_torch inference model (bad "
                f"magic {magic!r}); train checkpoints load via "
                f"paddle_tpu_torch.load")
        try:
            (n,) = struct.unpack("<I", f.read(4))
            meta = json.loads(f.read(n).decode())
        except (struct.error, ValueError, UnicodeDecodeError) as e:
            raise InvalidArgumentError(
                f"{path} is truncated or corrupt (unreadable header): {e}")
        blob = f.read()
    return meta, blob


class Config:
    """Predictor configuration (reference:
    inference/api/paddle_analysis_config.h).  The reference's IR / pass
    toggles have no meaning here; the surviving knobs are the file
    locations and the device."""

    def __init__(self, model_file: Optional[str] = None,
                 params_file: Optional[str] = None):
        if model_file and model_file.endswith(".pdmodel"):
            model_file = model_file[: -len(".pdmodel")]
        self.prefix = model_file
        self.params_file = params_file
        self.device: Optional[str] = None

    def set_prog_file(self, path: str):
        self.prefix = path[: -len(".pdmodel")] if path.endswith(".pdmodel") else path

    def enable_use_gpu(self, memory_pool_init_size_mb=None, device_id=0):
        self.device = f"cuda:{int(device_id)}"

    def disable_gpu(self):
        self.device = "cpu"


def _read_state(path: str, meta):
    """``{"params": {name: array}, "buffers": ...}`` of a ``.pdiparams``,
    checked against the artifact's signature: the same names, and each
    array the declared shape."""
    state = serialization.load(path)
    if not isinstance(state, dict) or "params" not in state:
        raise InvalidArgumentError(f"{path} is not an inference params file")
    out = {}
    for kind in ("params", "buffers"):
        have = state.get(kind, {})
        want = meta[kind]
        if sorted(have) != sorted(n for n, _, _ in want):
            raise InvalidArgumentError(
                f"{path} {kind} do not match the served model (different "
                f"names: {sorted(set(have) ^ {n for n, _, _ in want})[:5]})")
        for n, shape, _ in want:
            if tuple(np.shape(have[n])) != tuple(shape):
                raise InvalidArgumentError(
                    f"{path} {kind} {n!r} is {tuple(np.shape(have[n]))}, the "
                    f"served model's {tuple(shape)}")
        out[kind] = {n: have[n] for n, _, _ in want}
    return out


def _file_signature(state):
    return {kind: {n: (tuple(np.shape(a)), np.asarray(a).dtype.name)
                   for n, a in leaves.items()}
            for kind, leaves in state.items()}


class _Executable:
    """One fixed input geometry of a Predictor: on a card a CUDA graph over
    the exported module (the inputs copied into its static buffers, the
    weights read from the Predictor's tensors in place), on the CPU the
    module at that geometry."""

    def __init__(self, shapes, graph=None, inputs=None, outputs=None):
        self.shapes = shapes
        self.graph = graph
        self.inputs = inputs
        self.outputs = outputs


class Predictor:
    """A loaded artifact and its weights on one device.

    Reference: AnalysisPredictor (inference/api/analysis_predictor.h:82).
    ``device`` — ``None`` is the card (``cuda:0``, or what ``set_device``
    chose; no card raises ``UnavailableError``), ``"cpu"`` the CPU.  The
    artifact must list the device's platform."""

    def __init__(self, path_prefix: str, device: Optional[str] = None,
                 params_file: Optional[str] = None):
        self._meta, blob = _read_model_file(path_prefix + ".pdmodel")
        self.device = resolve_device(device)
        platform = _platform(self.device)
        if platform not in self._meta["platforms"]:
            raise InvalidArgumentError(
                f"{path_prefix}.pdmodel was exported for "
                f"{self._meta['platforms']}, not {platform!r} "
                f"({self.device}): export it with platforms=(..., "
                f"{platform!r})")
        ep = torch.export.load(io.BytesIO(blob))
        if torch.device(self._meta["trace_device"]) != self.device:
            # device constants baked into the graph follow the weights
            from torch.export.passes import move_to_device_pass

            ep = move_to_device_pass(ep, self.device)
        self._module = ep.module()
        self._dtypes = {kind: {n: convert_dtype(dt)
                               for n, _, dt in self._meta[kind]}
                        for kind in ("params", "buffers")}
        self._lock = threading.Lock()
        state = _read_state(params_file or path_prefix + ".pdiparams",
                            self._meta)
        self._signature = _file_signature(state)
        self._weights = {
            kind: {n: numpy_to_tensor(a).to(self.device,
                                            self._dtypes[kind][n])
                   for n, a in state[kind].items()}
            for kind in ("params", "buffers")}

    # -- paddle inference api surface ---------------------------------------
    def get_input_names(self) -> List[str]:
        return [i["name"] for i in self._meta["inputs"]]

    def get_num_outputs(self) -> int:
        return self._meta["n_outputs"]

    def _inputs(self, inputs) -> List[torch.Tensor]:
        declared = self._meta["inputs"]
        if len(inputs) != len(declared):
            raise InvalidArgumentError(
                f"predictor takes {len(declared)} inputs "
                f"({[d['name'] for d in declared]}), got {len(inputs)}")
        return [numpy_to_tensor(x).to(self.device, convert_dtype(d["dtype"]))
                for x, d in zip(inputs, declared)]

    def _call(self, ins):
        w = self._weights
        return list(self._module(w["params"], w["buffers"], *ins))

    def run_tensors(self, inputs: Sequence) -> List[torch.Tensor]:
        """Run on tensors or arrays (each cast to its declared dtype and
        moved to the device); the outputs stay tensors on the device."""
        ins = self._inputs(inputs)
        with torch.no_grad(), self._lock:
            return self._call(ins)

    def run(self, inputs: Sequence) -> List[np.ndarray]:
        """numpy (or tensors) in → numpy out."""
        return [to_numpy(o) for o in self.run_tensors(inputs)]

    # -- serving hooks (serving.InferenceEngine) -----------------------------
    def input_dtypes(self) -> List[torch.dtype]:
        return [convert_dtype(i["dtype"]) for i in self._meta["inputs"]]

    def aot_compile(self, input_shapes: Sequence[Sequence[int]]):
        """The module for ONE fixed input geometry, run through
        :meth:`run_compiled` — the counterpart of one XLA executable per
        geometry.  On a card it is a CUDA graph captured over the exported
        module: the weights are the graph's input tensors, so
        :meth:`swap_weights` needs no recapture.  The serving engine holds
        exactly one a shape bucket."""
        declared = self._meta["inputs"]
        if len(input_shapes) != len(declared):
            raise InvalidArgumentError(
                f"aot_compile takes {len(declared)} input shapes, got "
                f"{len(input_shapes)}")
        shapes = [tuple(int(d) for d in s) for s in input_shapes]
        if self.device.type != "cuda":
            return _Executable(shapes)
        ins = [torch.zeros(s, dtype=dt, device=self.device)
               for s, dt in zip(shapes, self.input_dtypes())]
        with torch.no_grad(), self._lock, torch.cuda.device(self.device):
            side = torch.cuda.Stream()
            side.wait_stream(torch.cuda.current_stream())
            with torch.cuda.stream(side):  # build, load, size the grids
                for _ in range(2):
                    self._call(ins)
            torch.cuda.current_stream().wait_stream(side)
            graph = torch.cuda.CUDAGraph()
            with torch.cuda.graph(graph):
                outs = self._call(ins)
        return _Executable(shapes, graph, ins, outs)

    def run_compiled_tensors(self, executable: _Executable,
                             inputs: Sequence) -> List[torch.Tensor]:
        """Run an :meth:`aot_compile` executable with the CURRENT weights;
        the inputs must have its geometry.  Returns copies of the outputs
        (the graph's own buffers are rewritten by the next replay)."""
        ins = self._inputs(inputs)
        got = [tuple(t.shape) for t in ins]
        if got != executable.shapes:
            raise InvalidArgumentError(
                f"executable compiled for {executable.shapes}, got {got}")
        with torch.no_grad(), self._lock:
            if executable.graph is None:
                return self._call(ins)
            for dst, src in zip(executable.inputs, ins):
                dst.copy_(src)
            executable.graph.replay()
            return [o.clone() for o in executable.outputs]

    def run_compiled(self, executable: _Executable,
                     inputs: Sequence) -> List[np.ndarray]:
        return [to_numpy(o)
                for o in self.run_compiled_tensors(executable, inputs)]

    def swap_weights(self, params_file: str) -> None:
        """Copy the weights of a ``.pdiparams`` side-file into the served
        tensors in place — no re-export, no recapture.  The file must
        match the served model's names and the shapes and dtypes of the
        file it was loaded from; a mismatched one is rejected before any
        tensor is written."""
        state = _read_state(params_file, self._meta)
        if _file_signature(state) != self._signature:
            raise InvalidArgumentError(
                f"swap_weights: {params_file} does not match the served "
                f"model (different leaf shapes/dtypes)")
        new = {kind: {n: numpy_to_tensor(a) for n, a in state[kind].items()}
               for kind in ("params", "buffers")}
        with torch.no_grad(), self._lock:
            for kind, leaves in new.items():
                for n, t in leaves.items():
                    self._weights[kind][n].copy_(t)
            if self.device.type == "cuda":
                torch.cuda.synchronize(self.device)


def create_predictor(config: Config) -> Predictor:
    if not config.prefix:
        raise InvalidArgumentError("Config has no model file set")
    return Predictor(config.prefix, device=config.device,
                     params_file=config.params_file)


def load_inference_model(path_prefix: str,
                         device: Optional[str] = None) -> Predictor:
    """Convenience loader (reference: fluid/io.py load_inference_model)."""
    return Predictor(path_prefix, device=device)
