"""Launch drivers on the port: ``serve`` (the paged serving engine over
the port's model), ``train`` (the training driver with its checkpoint
store and data cursor), ``steps`` (the step builders) and ``elastic``
(the fleet monitor and the elastic re-mesh policies)."""
