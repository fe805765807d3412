"""PyTorch/CUDA port of the ``repro`` serving and training stack.

The package mirrors ``repro``'s module names so each counterpart is easy to
find.  It imports ``torch`` and never ``jax``; a tensor's device chooses the
path: CUDA tensors launch the hand-written Hopper kernels in
``repro_torch.kernels.csrc``, CPU tensors take their plain PyTorch versions
(``repro_torch.kernels.ref``).  Entry points run on ``cuda`` unless the
caller passes ``device="cpu"``.
"""
