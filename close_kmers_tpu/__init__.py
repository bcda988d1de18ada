"""close_kmers_tpu: a JAX signature-kmer annotation framework (PATRIC/SEED
close_kmers and its kser server, rebuilt around batched device probes)."""
