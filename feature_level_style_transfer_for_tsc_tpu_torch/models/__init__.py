"""OS-CNN model family (eval mode) and shared primitives."""
