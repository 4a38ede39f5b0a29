"""khoice-tpu: a k-mer analysis engine in JAX.

A from-scratch rebuild of the capabilities of the khoice experiment pipeline
(reference: vshiv18/khoice) as one accelerator program (an NVIDIA H100):

- canonical k-mer counting from packed sequence batches (JAX/XLA),
  replacing the reference's external KMC3 binary
  (reference: workflow/rules/exp_type_1.smk:163)
- k-mer set algebra (union-with-count-sum, intersect-with-count-sum,
  subtract) on sorted static-shape device tables, replacing kmc_tools
  (reference: workflow/rules/exp_type_1.smk:173-191, exp_type_2.smk:362-380)
- occurrence histograms and the discriminatory-power metrics swept over a
  grid of k values (reference: workflow/Snakefile:36)
- read/genome classification with confusion matrices
  (reference: src/merge_lists.py, src/analyze_sam.py)
- multi-device scaling via jax.sharding.Mesh + shard_map with key-range
  partitioned tables (all set algebra is comms-free after one all_to_all).
"""

__version__ = "0.1.0"
