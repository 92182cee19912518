"""repro_torch: the PyTorch/CUDA port of the ``repro`` package.

The port mirrors ``repro``'s sub-packages and module names wherever a
reader looks for a counterpart, and keeps the JAX layouts at public
functions (attention in ``(B, S, H, D)``, weight matrices as
``(in, out)`` applied as ``x @ w``) so that the two packages can be held
against each other on the same inputs.  It imports nothing of ``repro``
and nothing of JAX.

Entry points run on CUDA unless the caller asks for the CPU; see
:func:`repro_torch.device.resolve_device`.
"""
