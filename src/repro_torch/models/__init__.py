"""The served language models (dense, moe, vlm and audio families),
serving path."""
