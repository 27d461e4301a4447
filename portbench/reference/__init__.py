"""Plain references of the model families, one module a family.

Each module gives ``dims(hf)`` (the sizes it reads from a configuration
file's published keys), ``leaves(d)`` (the weights' names, shapes and
roles, in the port's naming: ``weights.make`` builds them) and
``logits(d, w, seqs, positions, quant)``: float32 logits of the whole
causal forward pass over each sequence, at the positions asked for.  They
are written from the published descriptions in plain ``torch``, compute
in float32 with TF32 off, and import nothing of the port.  ``quant="fp8"``
computes in float8 (e4m3) what the program computes in bf16: every
matrix product from float8 inputs, and the residual stream and the cache
rounded to float8 (scaled a row): the control that a comparison has to
fail.
"""
import importlib


def family(name: str):
    """The reference module of a family (``reference/<name>.py``)."""
    return importlib.import_module(f"portbench.reference.{name}")
