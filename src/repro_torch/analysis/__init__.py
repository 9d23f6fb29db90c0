"""The port's analysis of its own programs: ``roofline`` counts a step's
FLOPs and bytes on ``meta`` tensors and sets them against one H100's
spec-sheet rates (the dry run's roofline, ``launch.dryrun``)."""
