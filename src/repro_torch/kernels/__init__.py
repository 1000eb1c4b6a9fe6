"""Hand-written Hopper kernels of the port, each beside its plain PyTorch
version: the STD cache's serving step (:mod:`.cache_ops`) and LDA topic
inference (:mod:`.topic_score`).  The CUDA sources live in
``repro_torch/csrc`` and build at first use, one library per source, all
in parallel (:mod:`repro_torch.kernels._build`)."""
