"""plass_tpu_torch — `plass assemble`, `penguin nuclassemble`,
`penguin guided_nuclassemble`, `linclust`, `search` (also iterative and
against profiles), `cluster`, `taxonomy` and the profile, linsearch,
multi-hit and taxonomy tools in PyTorch and CUDA.

A port of `plass_tpu` (JAX/Pallas) to PyTorch on an NVIDIA Hopper GPU. The
JAX package stays beside it as the reference the port is held against.

 - the device k-mer matcher (ops/device_kmer.py) is plain torch around a
   hand-written CUDA segmented-scan kernel (csrc/seg_scan.cu)
 - the END_TO_END and HAMMING diagonal rescores run in a hand-written
   CUDA kernel (csrc/rescore.cu) on the device-resident hits
 - the amino-acid aligner (ops/protein_align.py) scores its candidate
   pairs in a hand-written CUDA Smith-Waterman kernel (csrc/sw_score.cu)
 - the cycle check (assembler/cyclecheck.py) is a batched sort, carries
   and sparse histogram in torch and numpy
 - `--backend sharded` runs the k-mer matcher across the ranks of a
   torch.distributed group (parallel/): collectives exchange the table and
   the pairs, and every rank runs both kernels on its share
 - host layers (data/, the greedy extenders, proteinaln2nucl, the linclust
   tail, the aligner's native striped Smith-Waterman, the sensitive
   prefilter, the profile and MSA code, the NCBI taxonomy, the CLI's flag
   registry, the workflow engine) are copies of the JAX package's
   numpy/ctypes code

Nothing here imports jax or plass_tpu, nor reads a file of it: `import
plass_tpu` turns on jax at import time, and the GPU machine has no jax. The
port carries its own copies of what it reads at run time, the constant
tables under `constants/data/` and the C++ sources of the host kernels
under `native/`, so a directory that holds only this package runs every
command.
"""
import os

# Build outputs of the CUDA kernels and the host C++ library.
BUILD_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)), "_build")

__version__ = "0.1.0"
