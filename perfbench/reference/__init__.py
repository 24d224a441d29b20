"""The plain reference: a dense GQA decoder's loss, gradients, AdamW steps
and CRAIG proxy features in fp32 with TF32 off, and the facility-location
greedy in fp64.  It imports nothing of the program under test; it reads
the configuration file's sizes and the benchmark's own weights and
tokens.  ``precision='fp8'`` puts every matrix product's operands through
e4m3 with a per-tensor scale: the control that the comparison must fail.
"""
