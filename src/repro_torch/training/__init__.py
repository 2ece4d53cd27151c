"""Training in the port: fp32-master AdamW (``optimizer``), the train
step with microbatch accumulation, grad-spike skipping and the fleet
step (``loop``), and the crash-recovering loop (``resilient``)."""
