"""Several devices and several processes: the cursor stripes of one
process's devices (:mod:`.devices`) and the word-striped and
block-striped pods over ``torch.distributed`` (:mod:`.multihost`)."""
