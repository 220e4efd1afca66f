"""Probes: small measurements of one kernel against the library's calls,
run as ``python -m rwrt_tpu_torch.probes.<name>`` on the card."""
