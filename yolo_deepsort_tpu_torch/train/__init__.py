"""Training: YOLO detection training (loss, CLI) and ReID classifier
training (the reference's deep_sort/deep/train.py), in torch autograd."""
