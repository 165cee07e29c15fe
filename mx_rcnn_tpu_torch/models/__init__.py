"""Models: ResNet backbone/head, RPN, the tiny test network and the composite FasterRCNN."""
