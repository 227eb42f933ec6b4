"""Frozen MODWT filters (g̃, h̃): the decomposition banks, unit-L2
normalised and divided by √2, as the MODWT of JWave-Pro
(``MODWTTransform.initializeFilterCache``) defines them."""

#: Daubechies 4 (eight taps, four vanishing moments), JWave-Pro's
#: tap order.
DAUBECHIES_4 = (
    (-0.007493494665133498, 0.023251800535570855, 0.021808150237400178,
     -0.13225358368443177, -0.019787513117919237, 0.44610006912339817,
     0.5054728575458859, 0.16290171402569606),
    (0.16290171402569606, -0.5054728575458859, 0.44610006912339817,
     0.019787513117919237, -0.13225358368443177, -0.021808150237400178,
     0.023251800535570855, 0.007493494665133498),
)

HAAR = ((0.5, 0.5), (0.5, -0.5))

BY_NAME = {"Daubechies 4": DAUBECHIES_4, "Haar": HAAR}
