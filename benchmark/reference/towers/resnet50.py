"""ResNet-50, the audio tower ``resnet50``: 3, 4, 6 and 3 bottlenecks a
stage, features of 2048."""

from benchmark.reference.resnet_audio import AudioBottleneck, AudioResNet


def build(channels):
    return AudioResNet(AudioBottleneck, (3, 4, 6, 3), channels)
