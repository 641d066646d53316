"""Run configuration shared by the port's modules (a copy of what the port
needs from ``llm_interpretation_replication_tpu/config``)."""

# Length buckets of the sweep: prompts pad to the smallest bucket that holds
# the longest prompt of their batch.  Step 16 in the two hot zones (the
# perturbation corpus, 64-256; the few-shot shape, 400-448).
DEFAULT_BUCKETS = (64, 80, 96, 112, 128, 144, 160, 176, 192, 208, 224, 240,
                   256, 320, 384, 416, 432, 448,
                   512, 640, 768, 1024, 1536, 2048)
