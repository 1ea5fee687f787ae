from . import (  # noqa: F401  (MODEL registrations)
    apinet,
    baseline,
    bcnn,
    cbcnn,
    cin,
    crossx,
    dcl,
    interp_parts,
    mpn,
    osme,
    peer_learning,
    prototree,
)
