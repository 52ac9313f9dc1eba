"""Coconut on PyTorch and CUDA: the port of the JAX/Pallas package ``repro``.

Same subpackage layout as the reference (``core``, ``kernels``, ``query``,
``storage``, ``ingest``, ``distributed``, ``obs``, ``data``, ``configs``,
``models``, ``launch``); entry points run on the CUDA device unless the
caller asks for the CPU, where every kernel's plain twin runs instead.
"""
