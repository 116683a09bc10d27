"""Multi-species speciation: stochastic transformations between chemical
and physical species through a transfer-rate matrix.

Port of ``opendrift_tpu/ops/speciation.py``, the step RadionuclideDrift
and ChemicalDrift share (reference: opendrift/models/radionuclides.py:
728-810 ``update_speciation``, a per-element loop; here one vectorised
categorical draw).  Its two uniforms are bit-equal to the JAX package's
(``rng.split``); a destination may still differ where the two libraries'
``exp`` or ``cumsum`` round a probability differently
(``tests/test_torch_chemistry.py`` states the share).
"""

import torch

from .. import rng


def speciation_step(specie, rates_row, dt, key, active):
    """One speciation step.

    specie: int32 (N,) current specie index; rates_row: float32 (N, S)
    transfer rates from each element's current specie to every destination
    (already modulated by the environment).  Returns (new_specie,
    transformed mask)."""
    p = 1.0 - torch.exp(-rates_row * abs(dt))            # (N, S)
    psum = p.sum(dim=1)
    k1, k2 = rng.split(key)
    shape = tuple(specie.shape)
    u1 = rng.uniform(k1, shape, device=specie.device)
    transform = active & (u1 < psum)
    # categorical over destinations, conditional on transformation: the
    # first destination whose cumulative probability reaches u2, and 0
    # where none does (argmax of an all-False row, as jnp.argmax gives)
    u2 = rng.uniform(k2, shape, device=specie.device)
    # the running sum a column at a time, in XLA's left-to-right order:
    # torch.cumsum along a 5-wide last dimension takes a scan kernel that
    # needed 11.6 ms for 2M rows on an H100
    cols = [p[:, 0]]
    for j in range(1, p.shape[1]):
        cols.append(cols[-1] + p[:, j])
    cum = torch.stack(cols, dim=1) / torch.clamp_min(psum, 1e-30)[:, None]
    reached = (cum >= u2[:, None]).to(torch.uint8)
    dest = torch.argmax(reached, dim=1).to(specie.dtype)
    return torch.where(transform, dest, specie), transform
