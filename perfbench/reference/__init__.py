"""The plain reference: the models' forward pass, loss and gradients, and
AdamW with fp32 or int8 moments, in plain PyTorch and fp32 (TF32 off).

It follows the published descriptions of the configured models (their
forms, ``perfbench/forms/``) and imports nothing of the port, of ``jax``
or of the JAX package.  It takes the weights and inputs from ``perfbench.weights``
and works everything else out again.  ``precision.FP8`` puts every product
in the nearest precision below the served bf16 (fp8 e4m3 operands): the
control that the comparison has to fail.
"""
