"""Data loading: the COCO / synthetic image corpus and its batched loader."""
