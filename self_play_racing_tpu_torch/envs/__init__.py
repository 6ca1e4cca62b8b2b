"""Track pools, the single-car env, lockstep autoreset and obs normalization."""
