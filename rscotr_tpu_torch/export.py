"""Ahead-of-time export of the per-task inference steps for serving
(counterpart of rscotr_tpu/export.py, whose artifact is StableHLO).

Each task's step from ``engine/infer.make_infer_steps`` is traced with
``torch.export.export`` at one static (bs, size) bucket and saved with
``torch.export.save``. The artifact directory (``{task}.pt2``,
``params.npz``, ``meta.json``) serves WITHOUT the model code: loading is
``np.load`` + ``torch.export.load`` + ``import rscotr_tpu_torch.ops``, which
registers the operators the programs call, K1's forward as
``rscotr_torch::msda_fwd`` and K2's as ``rscotr_torch::window_attn_fwd``.
So a served det or seg request launches the hand-written kernels from inside
the program; a program holding their plain versions is refused at export.

Calling convention, as JAX's: every program takes the FLAT list of the
model's state-dict tensors (parameters and buffers, in state-dict order, the
mm layout of the port's checkpoints) followed by the task inputs. The
weights are stored once, in ``params.npz``, not in each program.

A program is traced on the device of the model's weights and holds that
device in its constants; ``meta.json`` names it, and ``load_artifact``
refuses an artifact of another device type than the one asked for.

Outputs mirror the test engine's contracts (engine/test.py):
  cls: (B, num_classes) softmax probabilities
  det: ((B, max_per_img, 5) xyxy+score, (B, max_per_img) labels)
  seg: (B, H, W) int64 label map
"""

from __future__ import annotations

import json
import os
from typing import Callable, Dict, Optional, Sequence, Tuple

import numpy as np
import torch

import rscotr_tpu_torch.ops  # noqa: F401 -- registers the kernels' operators

META_NAME = "meta.json"
PARAMS_NAME = "params.npz"
# the operators a det / seg program must call (and cls's K2)
KERNEL_OPS = {"cls": ("rscotr_torch.window_attn_fwd",),
              "det": ("rscotr_torch.msda_fwd", "rscotr_torch.window_attn_fwd"),
              "seg": ("rscotr_torch.msda_fwd", "rscotr_torch.window_attn_fwd")}
# what the plain MSDA would have traced to
PLAIN_MSDA_OP = "grid_sampler"

_TASK_INPUT_NAMES = {
    "cls": ("img",),
    "det": ("img", "img_hw", "scale_factor"),
    "seg": ("img",),
}


def task_input_specs(task: str, bs: int, size: int,
                     img_dtype=torch.float32, device="cpu"):
    """Zero tensors of one task's inference inputs (static shapes: one
    program per (bs, size) bucket).

    ``img_dtype=torch.uint8`` exports a raw-bytes-in artifact: the inference
    steps normalize uint8 inputs on the device (engine/infer.py::
    device_normalize), so the mean / std are baked into the program and
    serving feeds resized raw pixels."""
    img = torch.zeros((bs, size, size, 3), dtype=img_dtype, device=device)
    if task == "det":
        return (img, torch.full((bs, 2), size, dtype=torch.int32,
                                device=device),
                torch.ones((bs, 4), dtype=torch.float32, device=device))
    return (img,)


class _Step(torch.nn.Module):
    """The model as a submodule, so ``functional_call`` can swap its
    weights, and one task's step as the forward."""

    def __init__(self, model, step):
        super().__init__()
        self.model = model
        self._step = step

    def forward(self, *inputs):
        return self._step(*inputs)


class _Serve(torch.nn.Module):
    """forward(weights, *inputs): the step with the model's state-dict
    tensors taken from ``weights``. Holds no parameter of its own, so the
    exported program lifts none into its state."""

    def __init__(self, model, step, names):
        super().__init__()
        object.__setattr__(self, "_inner", _Step(model, step))
        self._names = [f"model.{n}" for n in names]

    def forward(self, weights, *inputs):
        return torch.func.functional_call(
            self._inner, dict(zip(self._names, weights)), inputs)


def _dtype_name(dtype: torch.dtype) -> str:
    return str(dtype).replace("torch.", "")


def graph_ops(program) -> Dict[str, int]:
    """{call target: count} of an exported program's graph."""
    ops: Dict[str, int] = {}
    for node in program.graph.nodes:
        if node.op == "call_function":
            ops[str(node.target)] = ops.get(str(node.target), 0) + 1
    return ops


def check_kernel_ops(task: str, program) -> Dict[str, int]:
    """Raise unless the program calls the task's kernel operators and no
    ``grid_sampler`` (the plain MSDA); returns their counts."""
    ops = graph_ops(program)
    found = {op: sum(n for t, n in ops.items() if t.startswith(op + "."))
             for op in KERNEL_OPS[task]}
    plain = [t for t in ops if PLAIN_MSDA_OP in t]
    if not all(found.values()) or plain:
        raise RuntimeError(
            f"export {task}: the program calls {found} and {plain}; the "
            "kernels' operators must replace their plain versions")
    return found


def export_inference(model, shapes: Dict[str, dict], *,
                     tasks: Sequence[str] = ("cls", "det", "seg"),
                     max_per_img: int = 300, img_norm=None,
                     seg_test_cfg=None, img_dtype=torch.float32
                     ) -> Dict[str, "torch.export.ExportedProgram"]:
    """Trace each task's inference step on the device of ``model``'s
    weights. ``shapes``: {task: {"bs": int, "size": int}}, the per-task
    serving buckets. Returns {task: ExportedProgram}; pair with
    ``save_artifact`` to persist."""
    from rscotr_tpu_torch.engine.infer import make_infer_steps

    device = next(model.parameters()).device
    infer = make_infer_steps(model, max_per_img=max_per_img,
                             img_norm=img_norm, seg_test_cfg=seg_test_cfg)
    state = model.state_dict()
    weights = list(state.values())
    out = {}
    for task in tasks:
        specs = task_input_specs(task, int(shapes[task]["bs"]),
                                 int(shapes[task]["size"]),
                                 img_dtype=img_dtype, device=device)
        with torch.no_grad():
            # one eager call first fills the model's caches (the Swin shift
            # masks) with device tensors, which the trace then lifts as
            # constants on the device; a mask made while tracing would be a
            # host constant, copied to the device on every request
            infer[task](*specs)
            program = torch.export.export(
                _Serve(model, infer[task], list(state)),
                (weights,) + specs, strict=False)
        check_kernel_ops(task, program)
        off = [k for k, c in program.constants.items()
               if isinstance(c, torch.Tensor) and c.device != device]
        if off:
            raise RuntimeError(f"export {task}: constants {off} are not on "
                               f"{device}: each request would copy them")
        out[task] = program
    return out


def _leaf_key(i: int, name: str) -> str:
    return f"{i:05d}|{name}"


def _specs(values):
    return [[list(v.shape), _dtype_name(v.dtype)] for v in values]


def save_artifact(out_dir: str, exported: Dict, state_dict, shapes:
                  Dict[str, dict], *, classes=None, img_norm=None,
                  extra_meta: Optional[dict] = None) -> None:
    """Persist the programs, the flat weights and the metadata into
    ``out_dir``. ``state_dict``: the model's, as exported."""
    os.makedirs(out_dir, exist_ok=True)
    arrays = {_leaf_key(i, k): v.detach().cpu().numpy()
              for i, (k, v) in enumerate(state_dict.items())}
    np.savez(os.path.join(out_dir, PARAMS_NAME), **arrays)

    meta = {
        "torch_version": torch.__version__,
        "num_param_leaves": len(arrays),
        "tasks": {},
        "classes": classes or {},
        # (mean, std): baked into the program for uint8-input artifacts;
        # float32-input artifacts take inputs normalized with these stats
        # (None = the ImageNet default)
        "img_norm": ([list(img_norm[0]), list(img_norm[1])]
                     if img_norm is not None else None),
    }
    for task, program in exported.items():
        user_inputs = [n for n in program.graph.nodes if n.op == "placeholder"
                       and n.name in set(program.graph_signature.user_inputs)]
        outputs = [a.meta["val"] for a in
                   program.graph.output_node().args[0]]
        inputs = [n.meta["val"] for n in user_inputs[len(arrays):]]
        # the example inputs hold the weights: the program does not need
        # them, and params.npz has them once
        example, program._example_inputs = program._example_inputs, None
        try:
            torch.export.save(program, os.path.join(out_dir, f"{task}.pt2"))
        finally:
            program._example_inputs = example
        meta["tasks"][task] = {
            "device": inputs[0].device.type,
            "input_names": list(_TASK_INPUT_NAMES[task]),
            "input_specs": _specs(inputs),
            "output_specs": _specs(outputs),
            "bs": int(shapes[task]["bs"]),
            "size": int(shapes[task]["size"]),
        }
    meta.update(extra_meta or {})
    with open(os.path.join(out_dir, META_NAME), "w") as f:
        json.dump(meta, f, indent=2)


def load_artifact(out_dir: str, tasks: Optional[Sequence[str]] = None,
                  device: str = "cuda"
                  ) -> Tuple[Dict[str, Callable], dict]:
    """Load a served model WITHOUT the model code: returns ({task:
    fn(*inputs) -> outputs}, meta). The weights are loaded once onto
    ``device`` and closed over; inputs may be numpy arrays or tensors and
    are moved there. ``fn.program`` is the loaded ExportedProgram. Raises if
    a task was exported for another device type: a program runs where it
    was traced."""
    with open(os.path.join(out_dir, META_NAME)) as f:
        meta = json.load(f)
    dev = torch.device(device)
    tasks = list(tasks or meta["tasks"].keys())
    for task in tasks:
        made_on = meta["tasks"][task]["device"]
        if made_on != dev.type:
            raise ValueError(
                f"{out_dir}: the {task} program was exported on {made_on!r}"
                f" and cannot run on {dev.type!r}: export it again with "
                f"--device {dev.type}")
    with np.load(os.path.join(out_dir, PARAMS_NAME)) as z:
        flat = [torch.from_numpy(z[k]).to(dev) for k in sorted(z.files)]
    if len(flat) != meta["num_param_leaves"]:
        raise ValueError(f"{out_dir}: params.npz holds {len(flat)} tensors, "
                         f"meta.json {meta['num_param_leaves']}")

    fns: Dict[str, Callable] = {}
    for task in tasks:
        program = torch.export.load(os.path.join(out_dir, f"{task}.pt2"))
        fns[task] = _bind(program, flat, meta["tasks"][task], dev)
    return fns, meta


def _bind(program, flat, task_meta: dict, dev: torch.device) -> Callable:
    """fn(*task inputs) running the program's graph with the weights bound
    once. ``program.module()`` would flatten and check all of its inputs
    on every call, the weights too (664 tensors for the flagship), which
    costs more host time than the graph's calls take; here only the task
    inputs are checked, against ``task_meta``'s specs."""
    from torch.export.graph_signature import InputKind, OutputKind

    if any(s.kind != OutputKind.USER_OUTPUT
           for s in program.graph_signature.output_specs):
        raise ValueError("artifact program mutates its inputs")
    slots, task_slots, user = [], [], 0
    for spec in program.graph_signature.input_specs:
        if spec.kind == InputKind.USER_INPUT:
            if user < len(flat):
                slots.append(flat[user])
            else:
                task_slots.append(len(slots))
                slots.append(None)
            user += 1
        elif spec.kind == InputKind.CONSTANT_TENSOR:
            # where the trace found it: a host-made constant is moved by
            # the graph itself
            slots.append(program.constants[spec.target])
        else:
            raise ValueError(f"artifact program takes a {spec.kind.name}")
    specs = [(tuple(shape), getattr(torch, dtype))
             for shape, dtype in task_meta["input_specs"]]
    if len(task_slots) != len(specs):
        raise ValueError(f"artifact program takes {len(task_slots)} task "
                         f"inputs, meta.json {len(specs)}")
    graph = program.graph_module
    # the trace's checks of intermediate dtypes and devices (one per
    # ``.to``): the graph is static once its inputs are checked here, and
    # each check is a dispatched op of host time on every request
    checks = [n for n in graph.graph.nodes
              if n.target is torch.ops.aten._assert_tensor_metadata.default]
    for node in checks:
        graph.graph.erase_node(node)
    if checks:
        graph.recompile()

    @torch.inference_mode()
    def run(*inputs):
        if len(inputs) != len(specs):
            raise TypeError(f"takes {len(specs)} inputs, got {len(inputs)}")
        args = list(slots)
        for i, x, (shape, dtype) in zip(task_slots, inputs, specs):
            x = torch.as_tensor(x).to(dev)
            if tuple(x.shape) != shape or x.dtype != dtype:
                raise ValueError(f"input {tuple(x.shape)} {x.dtype}: the "
                                 f"program takes {shape} {dtype}")
            args[i] = x
        out = graph(*args)
        return out[0] if len(out) == 1 else tuple(out)

    run.program = program
    return run
