"""How many kernels one call launches on the card, read from a CUDA graph
capture of the call: nothing runs, and the CUDA driver records each launch
the call makes on the capturing stream as a kernel node with its function,
whose name the CUDA driver API gives back.

    n = kernel_launches(lambda: mrf.mrf_stage(x, packed, ks, ds), ("k1_bf16_unit_kernel",))

``graph_kernel_nodes`` reads a graph captured elsewhere the same way (the
serving pipeline's, ``inference/graphs.py`` with ``keep_graphs=True``).

The call must launch on torch's current stream (the port's kernel wrappers
do) and must not synchronize.  The profiler's device events are no substitute
here: late in a long process on an H100 they lost one or more of a stage's
kernels now and then.  Needs an NVIDIA GPU.
"""

from __future__ import annotations

import ctypes

import torch

_KERNEL_NODE = 0  # CU_GRAPH_NODE_TYPE_KERNEL


def _check(err: int, what: str) -> None:
    if err != 0:
        raise RuntimeError(f"{what} failed: CUresult {err}")


def kernel_launches(fn, names) -> int:
    """Kernels that one call of fn() launches whose (mangled) function name
    holds one of `names`."""
    graph = torch.cuda.CUDAGraph(keep_graph=True)
    with torch.cuda.graph(graph, capture_error_mode="thread_local"):
        fn()
    count = graph_kernel_nodes(graph, names)
    graph.reset()
    return count


def graph_kernel_nodes(graph: torch.cuda.CUDAGraph, names) -> int:
    """Kernel nodes of a captured graph (made with ``keep_graph=True``)
    whose (mangled) function name holds one of `names`."""
    cuda = ctypes.CDLL("libcuda.so.1")
    raw = ctypes.c_void_p(graph.raw_cuda_graph())
    n = ctypes.c_size_t(0)
    _check(cuda.cuGraphGetNodes(raw, None, ctypes.byref(n)), "cuGraphGetNodes")
    nodes = (ctypes.c_void_p * n.value)()
    _check(cuda.cuGraphGetNodes(raw, nodes, ctypes.byref(n)), "cuGraphGetNodes")
    count = 0
    for node in nodes:
        kind = ctypes.c_int(-1)
        _check(cuda.cuGraphNodeGetType(ctypes.c_void_p(node), ctypes.byref(kind)), "cuGraphNodeGetType")
        if kind.value != _KERNEL_NODE:
            continue
        params = (ctypes.c_uint8 * 256)()  # CUDA_KERNEL_NODE_PARAMS_v2 (72 bytes); its first field is the CUfunction
        _check(cuda.cuGraphKernelNodeGetParams_v2(ctypes.c_void_p(node), params), "cuGraphKernelNodeGetParams")
        name = ctypes.c_char_p()
        _check(cuda.cuFuncGetName(ctypes.byref(name), ctypes.c_void_p.from_buffer(params, 0)), "cuFuncGetName")
        count += any(k in name.value.decode() for k in names)
    return count
