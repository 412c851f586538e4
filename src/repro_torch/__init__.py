"""LLM-CoOpt on PyTorch and CUDA: the port of the JAX package ``repro`` to
one NVIDIA H100, grown slice by slice (see ROADMAP.md). It imports neither
JAX nor ``repro``; its tests hold each module against its ``repro``
counterpart.
"""
