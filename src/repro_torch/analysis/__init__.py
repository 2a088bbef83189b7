"""Cost model and roofline of the port's steps: ``hlo_cost`` counts the
operations and bytes a call makes on PyTorch's dispatch, ``roofline``
turns them into time terms against the H100's published peaks."""
