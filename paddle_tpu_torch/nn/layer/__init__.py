"""Layer modules (counterparts of ``paddle_tpu/nn/layer``)."""
