"""Entry points of the port: ``python -m improved_body_parts_tpu_torch.apps.demo_image``
and ``python -m improved_body_parts_tpu_torch.apps.evaluate``."""
