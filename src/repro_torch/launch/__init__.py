"""Launch drivers on the port: ``serve`` (the paged serving engine over
the port's model), ``train`` (the training driver with its checkpoint
store and data cursor), ``steps`` (the step functions and the dry run's
cells), ``dryrun`` (the dry run on ``meta`` tensors), ``mesh`` (its
meshes) and ``elastic`` (the fleet monitor and the elastic re-mesh
policies)."""
