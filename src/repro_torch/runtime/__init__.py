"""Runtime of the port: the serving steps (``steps``) and the batched serve
loop with HRM on the parameters (``serve_loop``). The training steps and
loop wait for ROADMAP.md, queue 1, item 7b."""
