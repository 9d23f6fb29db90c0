"""Launch drivers on the port: ``serve`` (the paged serving engine over
the port's model)."""
