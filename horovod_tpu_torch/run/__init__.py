"""The launcher side of horovod_tpu_torch, as far as the port has it:
:mod:`~horovod_tpu_torch.run.rendezvous`, the rendezvous KV store (its
HTTP server and client, TTL keys and tombstones, the write-ahead log,
fencing), which the elastic driver's membership plane and the
observability planes ride. ``horovod_tpu_torch.testing.run_world`` serves
one for a world of processes; the launcher and the store's replication
(``run/replication.py``) wait for ROADMAP Queue A item 12."""
