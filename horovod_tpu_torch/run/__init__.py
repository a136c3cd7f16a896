"""``horovodrun``-equivalent launcher of horovod_tpu_torch.

Counterpart of ``horovod_tpu/run/`` (reference ``horovod/run/``): CLI
parsing and the job's processes (:mod:`~horovod_tpu_torch.run.runner`,
``python -m horovod_tpu_torch.run`` / ``bin/hvdrun_torch``), slot
allocation (:mod:`~horovod_tpu_torch.run.hosts`), config-file and flag
plumbing (:mod:`~horovod_tpu_torch.run.config_parser`), process-tree
execution (:mod:`~horovod_tpu_torch.run.safe_exec`), the rendezvous KV
store (:mod:`~horovod_tpu_torch.run.rendezvous`) and its replication to
warm standbys (:mod:`~horovod_tpu_torch.run.replication`), and the
programmatic ``run()``.

The port's differences from the JAX launcher:

- one process per GPU slot, not one per host; ``-np`` is the number of
  GPUs;
- the data plane is ``torch.distributed``: the launcher serves the
  world's ``TCPStore`` and each slot forms its process group through
  ``env://`` as a client of it, and the native core's coordinator runs in
  rank 0 at an address the launcher exports;
- a SIGTERM to the launcher is forwarded to the workers as a
  preemption, and the job exits 75 once they have drained;
- with ``--kv-standbys``, the primary KV store runs as a process of its
  own.
"""

from horovod_tpu_torch.run.hosts import HostSlots, parse_hosts, allocate  # noqa: F401

_RUNNER = ("run", "run_commandline", "main")


def __getattr__(name):
    # the runner loads on first use: ``python -m horovod_tpu_torch.run.
    # replication`` (the primary KV store's process) must not find that
    # module imported by its own package first
    if name in _RUNNER:
        from horovod_tpu_torch.run import runner

        return getattr(runner, name)
    raise AttributeError(name)
