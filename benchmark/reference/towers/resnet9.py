"""ResNet-9, the audio tower ``resnet9``: one basic block a stage,
features of 512."""

from benchmark.reference.resnet_audio import AudioBasic, AudioResNet


def build(channels):
    return AudioResNet(AudioBasic, (1, 1, 1, 1), channels)
