"""Plain PyTorch float32 forwards of the benchmark's configurations.

One module a configuration family (``dense_decoder``, ``mamba2``), found by
the ``family`` of a configuration file.  Each has
``forward(params, tokens, config, precision="float32") -> logits`` in
float32 with TF32 off, computed layer by layer and in blocks so that it
fits beside the program's weights.  ``precision="fp8"`` rounds every
matmul operand to float8 e4m3 (the benchmark's control).  Nothing here
imports the program under test; the weights are the tensors the benchmark
made and handed to both sides.
"""
