"""The crack pipeline: attack spec, host plans, device arrays, superstep body."""
