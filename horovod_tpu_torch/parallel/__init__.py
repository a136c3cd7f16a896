"""Process topologies over the port's process group (:mod:`.mesh`)."""
