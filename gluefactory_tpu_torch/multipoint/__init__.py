"""The multispectral (optical / thermal) subpackage (counterpart of
gluefactory_tpu/multipoint): the MP pair dataset, MultiPoint, XPoint and
its backbones, and the detector evaluation metrics."""
