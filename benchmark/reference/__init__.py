"""The plain reference the benchmark holds the port to: an aligner
written from the genome and the reads alone, in numpy and torch tensor
operations, with its own k-mer index. It imports nothing of the port
(snap_tpu_torch) and nothing of JAX or the JAX package (snap_tpu), and
takes nothing the port built.
"""
