"""The port's model-path kernels as ``torch.library`` custom ops.

``torch.export`` cannot trace a kernel that ``nn.kernels`` launches through
``ctypes`` on raw pointers, so while a program is exported the wrappers of
``nn.kernels`` call these ops instead (``torch.compiler.is_exporting()``),
and the exported graph holds one node an op call.  Each op has:

* a CPU and a CUDA implementation, which are the ``nn.kernels`` wrapper
  itself: on a CPU tensor the kernel's plain PyTorch version, on a CUDA
  tensor the launch (float32, or the bf16 variant for bf16 tensors), which
  raises on what the kernel does not take and counts in
  ``nn.kernels.LAUNCHES``;
* a fake implementation (``register_fake``) that gives the output shapes
  and dtypes, which is all an export sees.

Ops: ``lstm`` (its state pair flattened into the outputs),
``dilated_conv1d``, ``banded_conv1d``, ``quantized_matmul`` and
``depth_draft`` (``PackedDepth``'s tensors as one list).  The depth-draft
probes have no op: no model path reaches them.

A program saved by ``mlx_audio_tpu_torch.export`` loads in a process that
has imported this module, and nothing of the port's models: importing it
imports ``nn.kernels`` and, through ``nn``, the layers, never ``models``,
``codec``, ``tts``, ``stt``, ``sts`` or ``parallel``.
"""

from __future__ import annotations

import torch
from torch import Tensor

from mlx_audio_tpu_torch.nn import kernels
from mlx_audio_tpu_torch.nn.pallas_depth import PackedDepth

NAMESPACE = "mlx_audio_tpu_torch"
OPS = ("lstm", "dilated_conv1d", "banded_conv1d", "quantized_matmul",
       "depth_draft")
_DEVICES = ("cpu", "cuda")


@torch.library.custom_op(f"{NAMESPACE}::lstm", mutates_args=(),
                         device_types=_DEVICES)
def lstm(x_proj: Tensor, wh: Tensor, h0: Tensor,
         c0: Tensor) -> tuple[Tensor, Tensor, Tensor, Tensor]:
    hs, cs, (h_last, c_last) = kernels.lstm(x_proj, wh, h0, c0)
    return hs, cs, h_last, c_last


@lstm.register_fake
def _(x_proj, wh, h0, c0):
    b, t, h4 = x_proj.shape
    hs = x_proj.new_empty((b, t, h4 // 4))
    h_last = x_proj.new_empty((b, h4 // 4))
    return hs, torch.empty_like(hs), h_last, torch.empty_like(h_last)


@torch.library.custom_op(f"{NAMESPACE}::dilated_conv1d", mutates_args=(),
                         device_types=_DEVICES)
def dilated_conv1d(x: Tensor, w: Tensor, dilation: int) -> Tensor:
    return kernels.dilated_conv1d(x, w, dilation)


@dilated_conv1d.register_fake
def _(x, w, dilation):
    return x.new_empty((x.shape[0], x.shape[1], w.shape[2]))


@torch.library.custom_op(f"{NAMESPACE}::banded_conv1d", mutates_args=(),
                         device_types=_DEVICES)
def banded_conv1d(x: Tensor, w: Tensor) -> Tensor:
    # the plain version returns a view of its padded rows; the op's output
    # is contiguous on every device, as the kernel's is
    return kernels.banded_conv1d(x, w).contiguous()


@banded_conv1d.register_fake
def _(x, w):
    return x.new_empty((x.shape[0], x.shape[1], w.shape[2]))


@torch.library.custom_op(f"{NAMESPACE}::quantized_matmul", mutates_args=(),
                         device_types=_DEVICES)
def quantized_matmul(x: Tensor, codes: Tensor, scales: Tensor, biases: Tensor,
                     group_size: int, packed: bool) -> Tensor:
    return kernels.quantized_matmul(x, codes, scales, biases, group_size, packed)


@quantized_matmul.register_fake
def _(x, codes, scales, biases, group_size, packed):
    return x.new_empty((x.shape[0], codes.shape[0]))


@torch.library.custom_op(f"{NAMESPACE}::depth_draft", mutates_args=(),
                         device_types=_DEVICES)
def depth_draft(packed: list[Tensor], cache_k0: Tensor, cache_v0: Tensor,
                c1: Tensor, noise: Tensor, vocab: int, temp: float,
                top_k: int) -> Tensor:
    return kernels.depth_draft(PackedDepth(*packed), cache_k0, cache_v0, c1,
                               noise, vocab, temp, top_k)


@depth_draft.register_fake
def _(packed, cache_k0, cache_v0, c1, noise, vocab, temp, top_k):
    return noise.new_empty((noise.shape[0],), dtype=torch.int32)


def graph_ops(program) -> dict:
    """{op name: call nodes} over an exported program's graph and every
    graph nested in it (the bodies of its loops), for the ops of this
    module."""
    counts = dict.fromkeys(OPS, 0)
    gm = getattr(program, "graph_module", program)
    for mod in gm.modules():
        if not isinstance(mod, torch.fx.GraphModule):
            continue
        for node in mod.graph.nodes:
            target = getattr(node.target, "name", None)
            if node.op == "call_function" and callable(target):
                name = target()
                if name.startswith(f"{NAMESPACE}::"):
                    key = name.split("::")[1].split(".")[0]
                    counts[key] = counts.get(key, 0) + 1
    return counts
