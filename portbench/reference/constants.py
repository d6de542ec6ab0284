"""Physical constants in CGS units.

TPU-native rebuild of the constant sets used by the reference implementation
(grackle: src/clib/phys_constants.h:29-71 and src/clib/phys_const.def, double
precision branch).  All values are bit-identical to the reference so that rate
tables and unit conversions agree to full double precision.
"""

# Boltzmann constant [erg/K]
kboltz = 1.3806504e-16

# Hydrogen mass [g]
mass_h = 1.67262171e-24
mh = mass_h

# Electron mass [g]
mass_e = 9.10938215e-28
me = mass_e

# Pi (double-precision value used by the reference Fortran kernels)
pi_val = 3.141592653589793

# Planck constant [erg s]
hplanck = 6.6260693e-27

# 1 eV in erg
ev2erg = 1.60217653e-12

# Speed of light [cm/s]
c_light = 2.99792458e10
clight = c_light

# Gravitational constant [cm^3 g^-1 s^-2]
GravConst = 6.67428e-8

# Stefan-Boltzmann constant [erg cm^-2 s^-1 K^-4]
sigma_sb = 5.670373e-5

# Solar mass [g]
SolarMass = 1.9891e33

# Distances [cm]
Mpc = 3.0857e24
kpc = 3.0857e21
pc = 3.0857e18

# Kelvin per eV (rate_functions.c:17)
tevk = 1.1605e4

# Numerical floors/ceilings (grackle_fortran_types.def)
tiny = 1.0e-20
huge = 1.0e20
tiny8 = 1.0e-40
huge8 = 1.0e40

# "dhuge" comparison value used in the analytic cooling fits
# (rate_functions.c:21)
dhuge = 1.0e30
