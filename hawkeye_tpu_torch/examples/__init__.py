"""The port's Example trainers: counterparts of the JAX package's
``Examples/*.py``, one module of the same name each, run as

    python -m hawkeye_tpu_torch.examples.<Name> --config configs/<X>.yaml [--device cpu]

on the CUDA device unless ``--device cpu`` is given. Every Example of the
JAX package is ported: Baseline, BCNN, CBCNN, MPN, PairConfusion,
PeerLearning, OSMENet, APINet, CIN, CrossX, InterpPartsNet, ProtoTreeNet,
DCL, NTSNet, APCNN, S3N and MGE_CNN.
"""

