"""What the benchmark measures against, kept beside it: the synthetic
tables' generator, the network region's byte count and the card's
published peaks.  Frozen: later changes add files beside these."""
