"""Runtime of the port: the step builders (``steps``), the batched serve
loop with HRM on the parameters (``serve_loop``) and the fault-tolerant
train loop with HRM on the parameters and optimizer moments
(``train_loop``)."""
