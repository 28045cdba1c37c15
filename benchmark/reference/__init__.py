"""The plain reference: the configurations' models, losses and Adam in
plain PyTorch, FP32 with TF32 off, worked out anew from the benchmark's
inputs (the seed's weights and generator state).  It imports nothing of the
program under test.  ``training.py`` follows the program's first steps."""
