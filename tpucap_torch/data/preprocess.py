"""Per-mode image normalization constants (copied from
``tpucap.data.preprocess``):

- caffe (VGG16/ResNet-50): RGB->BGR, then per-channel mean subtract;
- tf (InceptionV3): x/127.5 - 1;
- torch: x/255, then ImageNet mean/std.
"""

import numpy as np

CAFFE_MEAN_BGR = np.array([103.939, 116.779, 123.68], np.float32)
TORCH_MEAN = np.array([0.485, 0.456, 0.406], np.float32)
TORCH_STD = np.array([0.229, 0.224, 0.225], np.float32)
