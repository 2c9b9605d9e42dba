"""The results gallery (counterpart of aocr/visualizer)."""
